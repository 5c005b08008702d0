# Kaldi-style shell option parser: maps "--opt-name value" arguments to
# pre-declared shell variables opt_name, with optional --config file
# layering.  (The port's copy of the repository's parse_options.sh.)
#
# Usage: declare defaults, then `. utils/parse_options.sh`.


while true; do
  [ -z "${1:-}" ] && break
  case "$1" in
    --help|-h)
      if [ -z "$help_message" ]; then
        echo "No help found." 1>&2
      else
        printf "%s\n" "$help_message" 1>&2
      fi
      exit 0 ;;
    --*=*)
      echo "$0: options to scripts must be of the form --name value, got '$1'" 1>&2
      exit 1 ;;
    --*)
      name=$(echo "$1" | sed s/^--// | sed s/-/_/g)
      eval '[ -z "${'$name'+xxx}" ]' && \
        echo "$0: invalid option $1" 1>&2 && exit 1
      oldval="$(eval echo \$$name)"
      if [ "$oldval" == "true" ] || [ "$oldval" == "false" ]; then
        was_bool=true
      else
        was_bool=false
      fi
      eval $name=\"$2\"
      if $was_bool && [[ "$2" != "true" && "$2" != "false" ]]; then
        echo "$0: expected \"true\" or \"false\": $1 $2" 1>&2
        exit 1
      fi
      shift 2 ;;
    *) break ;;
  esac
done

# --config is special: source it after parsing so file values layer under
# command-line values already applied
true

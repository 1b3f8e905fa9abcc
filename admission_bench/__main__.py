import sys

from admission_bench.run import main

if __name__ == "__main__":
    sys.exit(main())

"""Entry point of the port's benchmark; see port_bench/harness.py."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# import the harness as the package `port_bench` from the checkout's root,
# not this directory's files as top-level modules
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))

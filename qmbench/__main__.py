"""python -m qmbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>"""

import time

T_START = time.perf_counter()      # set-up counts from here, imports too

import sys  # noqa: E402

from qmbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))

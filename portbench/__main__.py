"""``python3 -m portbench``: see :mod:`portbench.run`."""
import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``), 0 where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()   # set-up starts here

import sys  # noqa: E402

from portbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))

"""``calibrate.py`` for the protein scoring driver (not part of a benchmark
run): ``score_protein`` takes ``calibrate.py``'s scoring readings (program,
TF32 control, widest gaps, shares over each threshold).

    python3 bench_gpu/calibrate_protein.py <cell> <seed> [<seed> ...] [--calls N]

Prints one JSON line per seed.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_gpu import calibrate  # noqa: E402

calibrate.READINGS.update(score_protein=calibrate.score_readings)

if __name__ == "__main__":
    calibrate.main()

"""``calibrate.py`` for every cell, the held-out scoring drivers of the
attention AR and of MAP scoring included (not part of a benchmark run):

- ``score_attention`` takes ``calibrate.py``'s scoring readings (program,
  TF32 control, widest gaps, shares over each threshold);
- ``score_map``: ``program``, the numbers the check compares as a run
  reads them, and ``control``, the plain reference with its products in
  TF32 in the program's place, against the reference.

    python3 bench_gpu/calibrate_cells.py <cell> <seed> [<seed> ...] [--calls N]

Prints one JSON line per seed.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_gpu import calibrate  # noqa: E402


def map_readings(run, driver, calls):
    from bench_gpu.traffic import score_map

    driver.warmup()
    for _ in range(calls):
        driver.step()
    driver.release()
    idx = driver.checked_calls()
    want = [driver.reference_scores(i) for i in idx]
    out = {"program": driver.check(),
           "control": score_map.readings([driver.reference_scores(i, tf32=True) for i in idx],
                                         want)}
    return out


calibrate.READINGS.update(score_attention=calibrate.score_readings, score_map=map_readings)

if __name__ == "__main__":
    calibrate.main()

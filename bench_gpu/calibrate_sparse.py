"""``calibrate.py`` for the sparse-map and SNV-scan scoring drivers (not
part of a benchmark run): ``score_sparse`` takes ``calibrate.py``'s scoring
readings; ``score_snv`` the same readings over its SNVs, with the gaps of
``traffic/score_snv.py``.

    python3 bench_gpu/calibrate_sparse.py <cell> <seed> [<seed> ...] [--calls N]

Prints one JSON line per seed.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from bench_gpu import calibrate, harness  # noqa: E402


def snv_readings(run, driver, calls):
    snv = harness.load_module("traffic", "score_snv")
    driver.warmup()
    for _ in range(calls):
        driver.step()
    driver.release()
    out = {"program": driver.check()}
    idx = driver.checked_calls()
    want = [driver.reference_scores(i) for i in idx]
    got = [driver.outputs[i] for i in idx]
    ctrl = [driver.reference_scores(i, tf32=True) for i in idx]
    out["control"] = snv.readings(ctrl, want, run.params["share_over"])
    out["widest"] = {"program": [float(g.max()) for g in snv.gaps(got, want)],
                     "control": [float(g.max()) for g in snv.gaps(ctrl, want)]}
    out["shares_over"] = {
        side: {str(t): float(np.mean(snv.gaps(g, want)[0] > t)) for t in calibrate.SHARES_OVER}
        for side, g in (("program", got), ("control", ctrl))}
    return out


calibrate.READINGS.update(score_sparse=calibrate.score_readings, score_snv=snv_readings)

if __name__ == "__main__":
    calibrate.main()

"""Host time of one ``bear_net.train`` call outside its applies (the
call's set-up, the stacking of the dataset, the ELBOs and the optimizer
state copied out): the mean over the traced window's ``bear.train.call``
spans of their duration less their ``bear.train.apply`` children's, in
ms."""

from bench_gpu.metrics import _spans


def read(run):
    return _spans.mean_self_ms(run, "bear.train.call", "bear.train.apply")

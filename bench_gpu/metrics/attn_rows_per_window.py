"""Rows the attention AR evaluated per window scored in the traced window:
the program's ``models.ar_funcs.attention_rows`` counter, which the driver
resets at the end of its warm-up, over the windows scored. None untraced,
and where the program keeps no such counter."""


def read(run):
    if run.trace is None or not run.work["windows"]:
        return None
    from bear_tpu_torch.models import ar_funcs

    rows = getattr(ar_funcs, "attention_rows", None)
    return None if rows is None else rows / run.work["windows"]

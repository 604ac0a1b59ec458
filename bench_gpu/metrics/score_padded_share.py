"""Share of the positions that the traced window's sampled calls ran their
row math over that were padding: 100 x (1 - windows / padded positions),
the windows being the calls' real transitions and the padded positions the
program's ``inference.serving.padded_positions`` counter (B x (maxlen + 1)
a call), which the driver resets at the end of its warm-up, in %. None
untraced, and where the program keeps no such counter."""


def read(run):
    if run.trace is None:
        return None
    from bear_tpu_torch.inference import serving

    padded = getattr(serving, "padded_positions", None)
    if not padded:
        return None
    return 100.0 * (1.0 - run.work["windows"] / padded)

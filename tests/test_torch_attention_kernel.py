"""The attention AR's inference kernel (bear_tpu_torch/ops/attention_forward.py,
csrc/attention_forward.cu) on the CPU: its launch shape and shared-memory
mirror at the configuration's widths and at a second width, which calls it
takes (``AttentionAR._takes_attention_kernel``), what its wrapper refuses, and the
block's span and row counter on both paths. The kernel itself runs only on
a card: tests/test_torch_cuda.py holds it against the plain block there.
"""

import pytest
import torch

from bear_tpu_torch.models import ar_funcs
from bear_tpu_torch.models.ar_funcs import AttentionAR, get_ar_func
from bear_tpu_torch.ops import attention_forward as af
from bear_tpu_torch.utils import profiling

torch.set_num_threads(2)
# (lag, alphabet size, af_kwargs): bear_attn_bear.cfg's widths at the genome
# workload's lag, and a protein-sized second width with heads of 8.
WIDTHS = {"published": (13, 4, {"d_model": 64, "num_heads": 4, "mlp_width": 128}),
          "second": (5, 20, {"d_model": 24, "num_heads": 3, "mlp_width": 40})}


class _Input:
    """What the dispatch reads of an input: its device and whether it
    requires grad (a CUDA tensor cannot be made here)."""

    def __init__(self, device, requires_grad=False):
        self.device = torch.device(device)
        self.requires_grad = requires_grad


def _widths(name):
    lag, A, kw = WIDTHS[name]
    return lag, A + 1, kw["d_model"], kw["num_heads"], kw["mlp_width"]


def test_head_lanes_pad_each_head_to_a_power_of_two():
    assert af.head_lanes(64, 4, 4) == 4  # 16 columns: 4 lanes of 4 in float
    assert af.head_lanes(64, 4, 8) == 8  # of 2 in double
    assert af.head_lanes(24, 3, 4) == 2
    assert af.head_lanes(20, 4, 4) == 2  # 5 columns padded to 8
    assert af.head_lanes(64, 1, 4) == af.TEAM  # the widest head a team holds in float
    assert af.head_lanes(64, 1, 8) == af.TEAM  # in double it spans two blocks
    assert af.head_lanes(128, 1, 4) == af.TEAM
    # Column blocks of 16 lanes: heads side by side, or a wide head's own.
    assert af.column_blocks(64, 4, 4) == 1 and af.column_blocks(64, 4, 8) == 2
    assert af.column_blocks(24, 3, 4) == 1 and af.column_blocks(80, 5, 4) == 2
    assert af.column_blocks(64, 1, 8) == 2 and af.column_blocks(128, 1, 4) == 2
    assert af.column_blocks(192, 2, 4) == 4 and af.column_blocks(128, 1, 8) == 4


@pytest.mark.parametrize("name", list(WIDTHS))
def test_launch_shape_and_shared_memory(name):
    lag, A1, D, H, M = _widths(name)
    if name == "published":
        # wk and wv [1 block][64][2][64]; embed, pos; b1, b2, w_out, b_out
        # (517, to 520); a warp's two input buffers of 2 x 65 (132) and two
        # rows of 13 x 64 + 3 x 64, padded to 1,028 (4 banks apart);
        # resident: wq, wo, w1 and w2.
        per_warp = 2 * 132 + 2 * 1028
        assert (af.smem_bytes(8, 4, *_widths(name))
                == 4 * (8192 + 320 + 832 + 520 + 8 * per_warp) == 113_696)
        assert (af.smem_bytes(8, 4, *_widths(name), True)
                == 113_696 + 4 * (64 * 64 * 2 + 64 * 128 * 2))
        # The scoring cell's slices: every SM, 8 warps, the weights resident.
        for n in (1 << 18, 94_208):
            assert af.launch_shape(n, 4, 132, *_widths(name)) == (8, 132, True)
        # double: 4 blocks of 32 columns, 1,026-element rows; the weights do
        # not fit beside them, so they are read from device memory.
        assert af.smem_bytes(8, 8, *_widths(name)) == 226_864
        assert af.launch_shape(1 << 18, 8, 132, *_widths(name)) == (8, 132, False)
    else:
        # one block of 64 columns (3 heads of 2 lanes); b1, b2, w_out, b_out
        # 40 + 24 + 24 x 21 + 21 (to 592); rows of 13 x 24 + 3 x 24 padded to
        # 388; inputs 2 x 105 rounded to 212.
        per_warp = 2 * 212 + 2 * 388
        assert (af.smem_bytes(8, 4, *_widths(name))
                == 4 * (3072 + 21 * 24 + 5 * 24 + 592 + 8 * per_warp))
        assert (af.smem_bytes(8, 4, *_widths(name), True)
                == af.smem_bytes(8, 4, *_widths(name)) + 4 * (2 * 24 * 24 + 24 * 40 + 40 * 24))
        assert af.launch_shape(1 << 18, 8, 132, *_widths(name)) == (8, 132, True)
    # Few rows: a block per 16 rows, at least one.
    assert af.launch_shape(1, 4, 132, *_widths(name)).blocks == 1
    assert af.launch_shape(63, 4, 132, *_widths(name)).blocks == 4
    assert af.launch_shape(65, 4, 132, *_widths(name)).blocks == 5
    assert af.fits(4, *_widths(name)) and af.fits(8, *_widths(name))


def test_launch_shape_takes_fewer_warps_where_eight_do_not_fit():
    # A long lag: 8 warps of the published widths overflow shared memory in
    # double, fewer fit; past a block of one warp the widths do not fit.
    widths = (60, 5, 64, 4, 128)
    shape = af.launch_shape(1 << 18, 8, 132, *widths)
    assert shape.warps < 8 and not shape.resident
    assert af.smem_bytes(shape.warps, 8, *widths) <= af.SMEM_MAX
    assert af.smem_bytes(2 * shape.warps, 8, *widths) > af.SMEM_MAX
    assert not af.fits(4, 13, 5, 1024, 16, 128)


@pytest.mark.parametrize("name", list(WIDTHS))
def test_attention_kernel_dispatch(name):
    lag, A, kw = WIDTHS[name]
    cuda = _Input("cuda")
    for dtype in (torch.float32, torch.float64):
        ar = get_ar_func("attention", lag, A, kw, dtype=dtype, device="cpu")
        live = ar.params_list()
        assert ar._takes_attention_kernel(cuda, live)
        assert not ar._takes_attention_kernel(_Input("cpu"), live)
        # autograd would record: a parameter or the input requires grad
        assert not ar._takes_attention_kernel(cuda, [p.detach().requires_grad_() for p in live])
        assert not ar._takes_attention_kernel(_Input("cuda", requires_grad=True), live)
        with torch.no_grad():
            assert ar._takes_attention_kernel(_Input("cuda", requires_grad=True), live)
    ar16 = get_ar_func("attention", lag, A, kw, compute_dtype=torch.bfloat16, device="cpu")
    assert not ar16._takes_attention_kernel(cuda, ar16.params_list())


def test_attention_kernel_dispatch_refuses_widths_past_the_kernel():
    """Only shared memory routes a qualifying call to the ATen block: a
    block of one warp past it at d_model 1024, and at d_model 128 in double
    (wk and wv alone 262,144 bytes); one head of 64 columns (wider than a
    team in double) and of 128 in float take the kernel."""
    cuda = _Input("cuda")
    wide_smem = AttentionAR(13, 4, d_model=1024, num_heads=16, device="cpu")
    assert not wide_smem._takes_attention_kernel(cuda, wide_smem.params_list())
    assert af.smem_bytes(1, 4, 13, 5, 1024, 16, 128) > af.SMEM_MAX
    for dtype, D, takes in ((torch.float32, 64, True), (torch.float32, 128, True),
                            (torch.float64, 64, True), (torch.float64, 128, False)):
        ar = AttentionAR(13, 4, d_model=D, num_heads=1, dtype=dtype, device="cpu")
        assert ar._takes_attention_kernel(cuda, ar.params_list()) is takes
        assert af.fits(ar.params_list()[0].element_size(), 13, 5, D, 1, 128) is takes


def test_wide_heads_take_blocks_of_their_own_in_shared_memory():
    # One head of 128 columns in float: 2 column blocks of wk and wv [2][128]
    # [2][64]; embed, pos; b1, b2, w_out, b_out 64 + 128 + 640 + 5 (to 840);
    # a warp's inputs 2 x 132 and rows of 13 x 128 + 3 x 128 padded to 2,052.
    widths = (13, 5, 128, 1, 64)
    per_warp = 2 * 132 + 2 * 2052
    fixed = 2 * 128 * 2 * 64 + 5 * 128 + 13 * 128 + 840
    assert af.smem_bytes(4, 4, *widths) == 4 * (fixed + 4 * per_warp) == 213_536
    assert af.smem_bytes(8, 4, *widths) > af.SMEM_MAX
    assert af.launch_shape(1 << 18, 4, 132, *widths) == (4, 132, False)
    # In double a head of 64 takes the blocks of two heads of 32.
    assert (af.smem_bytes(4, 8, 13, 5, 64, 1, 128)
            == af.smem_bytes(4, 8, 13, 5, 64, 2, 128))
    assert af.fits(4, *widths) and not af.fits(8, *widths)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    lag, A, kw = WIDTHS["published"]
    ar = get_ar_func("attention", lag, A, kw, device="cpu")
    params = ar.params_list()
    x = torch.zeros((3, lag, A + 1))
    assert af.widths(x, params, 4) == (13, 5, 64, 4, 128)
    with pytest.raises(ValueError, match="CUDA card"):
        af.attention_probs(x, params, 4)
    with pytest.raises(TypeError, match="float32 or float64"):
        af.widths(x.half(), params, 4)
    with pytest.raises(TypeError, match="one type"):
        af.widths(x.double(), params, 4)
    with pytest.raises(ValueError, match="contiguous"):
        af.widths(torch.zeros((3, A + 1, lag)).transpose(1, 2), params, 4)
    with pytest.raises(ValueError, match="contiguous"):
        af.widths(x, params[:3] + [params[3].t()] + params[4:], 4)
    with pytest.raises(ValueError, match="pos is"):
        af.widths(torch.zeros((3, lag + 1, A + 1)), params, 4)
    with pytest.raises(ValueError, match="parameter arrays"):
        af.widths(x, params[:-1], 4)
    with pytest.raises(ValueError, match="multiple of num_heads"):
        af.widths(x, params, 5)
    wide = AttentionAR(13, 4, d_model=1024, num_heads=16, device="cpu")
    with pytest.raises(ValueError, match="shared memory"):
        af.widths(x, wide.params_list(), 16)


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_block_span_and_counter_on_both_paths(monkeypatch, path):
    """The span bear.ar.attention and the counter attention_rows around
    either path, once a block call; on the kernel path the wrapper gets the
    contiguous one-hot, the parameters and the head count (a stand-in for
    the launch, which needs a card)."""
    lag, A, kw = WIDTHS["second"]
    ar = get_ar_func("attention", lag, A, kw, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    codes = torch.randint(0, A + 1, (7, 3, lag), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = ar.apply_codes(codes)
    calls = []
    if path == "kernel":
        def fake(x, params, num_heads):
            calls.append((x.is_contiguous(), tuple(x.shape), num_heads))
            return ar._block_plain(params, x, (x.shape[0],), x.dtype)

        monkeypatch.setattr(AttentionAR, "_takes_attention_kernel", lambda self, x, live: True)
        monkeypatch.setattr(af, "attention_probs", fake)
    before, launches = ar_funcs.attention_rows, af.launches
    profiling.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with torch.no_grad():
                got = ar.apply_codes(codes)
                got_oh = ar(torch.nn.functional.one_hot(codes.long(), A + 1).float())
        names = [r.name for r in profiling.recorded()]
    finally:
        profiling.clear()
    assert names.count("bear.ar.attention") == 2
    assert ar_funcs.attention_rows - before == 2 * 21
    assert torch.equal(got, want) and torch.equal(got_oh, want) and got.shape == (7, 3, A + 1)
    assert calls == ([(True, (21, lag, A + 1), 3)] * 2 if path == "kernel" else [])
    assert af.launches == launches


def test_roofline_reader_reads_the_kernel_and_nothing_without_it():
    """bench_gpu's attn_forward_roofline: the block's model FLOPs over the
    windows scored at 67 TFLOP/s, over attention_forward_kernel's device
    time; None untraced and where the kernel did not run (the parent)."""
    from types import SimpleNamespace

    from bench_gpu import harness

    read = harness.load_module("metrics", "attn_forward_roofline").read
    config = harness.load_json(harness.BENCH, "configs", "genome_lag13_attention.json")
    trace = harness.TraceSummary(1.0, 5.0, {"void attention_forward_kernel<float>(...)": 0.25,
                                             "keyed_draw_kernel": 0.5}, {})
    run = SimpleNamespace(trace=trace, config=config, work={"windows": 618_496 * 10})
    assert read(run) == pytest.approx(100 * 274_432 * 618_496 * 10 / 67e12 / 0.25)
    assert read(SimpleNamespace(trace=None, config=config, work=run.work)) is None
    parent = harness.TraceSummary(1.0, 5.0, {"gemv2N_kernel": 0.8}, {})
    assert read(SimpleNamespace(trace=parent, config=config, work=run.work)) is None

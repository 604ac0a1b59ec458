"""The port's CNN and stop AR functions against bear_tpu's, on the CPU in
float64, from the same parameters (bear_tpu's init, carried as numpy).

Tolerances: values and gradients rtol 1e-10 (the frameworks sum the same
products in another order); ``apply_codes`` against ``forward`` of the
one-hot rtol 1e-12 (the same sums, banded or windowed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bear_tpu.models import get_ar_func as jget_ar_func
from bear_tpu.ops import alphabets as jalph
from bear_tpu_torch.models.ar_funcs import CNNAR, StopAR, get_ar_func
from bear_tpu_torch.ops import alphabets

torch.set_num_threads(2)
LAG = 9
KW = {"filter_width": 4, "num_filters": 12, "kmer_layer1_width": 10}


def _setup(seed, n=200, alphabet="dna", kw=KW, lag=LAG):
    A = alphabets.alphabet_size(alphabet)
    jar = jget_ar_func("cnn", lag, A, kw, dtype=jnp.float64)
    params = [np.asarray(p) for p in jar.init(jax.random.key(seed))]
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, A + 1, size=(n, lag)).astype(np.int8)
    ar = get_ar_func("cnn", lag, A, kw, dtype=torch.float64, device="cpu")
    return jar, params, codes, ar, A


def _tparams(params):
    return [torch.tensor(p, requires_grad=True) for p in params]


@pytest.mark.parametrize("seed,alphabet", [(0, "dna"), (1, "prot")])
def test_cnn_values_match(seed, alphabet):
    jar, params, codes, ar, A = _setup(seed, alphabet=alphabet)
    oh = np.asarray(jalph.one_hot(codes, A + 1, jnp.float64))
    want = np.asarray(jax.jit(jar.apply)(params, oh))
    want_codes = np.asarray(jax.jit(jar.apply_codes)(params, codes))
    tp = [torch.tensor(p) for p in params]
    got = ar(torch.tensor(oh), tp)
    got_codes = ar.apply_codes(torch.tensor(codes), tp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    np.testing.assert_allclose(got_codes.numpy(), want_codes, rtol=1e-10)
    np.testing.assert_allclose(got_codes.numpy(), got.numpy(), rtol=1e-12)
    # The module's own parameters, once loaded, give the same.
    ar.load_params(params)
    np.testing.assert_allclose(ar.apply_codes(torch.tensor(codes)).detach().numpy(),
                               want_codes, rtol=1e-10)
    assert [tuple(p.shape) for p in ar.params_list()] == [p.shape for p in params]


@pytest.mark.parametrize("path", ["forward", "apply_codes"])
def test_cnn_gradients_match(path):
    jar, params, codes, ar, A = _setup(2)
    w = np.random.default_rng(3).normal(size=(len(codes), A + 1))
    oh = np.asarray(jalph.one_hot(codes, A + 1, jnp.float64))
    if path == "forward":
        jf = lambda p: jnp.sum(jnp.log(jar.apply(p, oh)) * w)  # noqa: E731
        x = torch.tensor(oh)
        fn = ar.forward
    else:
        jf = lambda p: jnp.sum(jnp.log(jar.apply_codes(p, codes)) * w)  # noqa: E731
        x = torch.tensor(codes)
        fn = ar.apply_codes
    want = jax.jit(jax.grad(jf))([jnp.asarray(p) for p in params])
    tp = _tparams(params)
    (torch.log(fn(x, tp)) * torch.tensor(w)).sum().backward()
    for g, wg in zip(tp, want):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(wg), rtol=1e-10, atol=1e-14)


def test_cnn_lead_shape_and_refusals():
    jar, params, codes, ar, A = _setup(4, n=24)
    tp = [torch.tensor(p) for p in params]
    got = ar.apply_codes(torch.tensor(codes).reshape(2, 12, LAG), tp)
    want = np.asarray(jax.jit(jar.apply_codes)(params, codes.reshape(2, 12, LAG)))
    assert got.shape == (2, 12, A + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    with pytest.raises(ValueError, match="filter_width"):
        CNNAR(3, 4, filter_width=4, device="cpu")
    with pytest.raises(ValueError, match="parameter arrays"):
        ar.load_params(params[:-1])
    # attention is ported: the same name builds it, and it matches bear_tpu's.
    att_kw = {"d_model": 8, "num_heads": 2, "mlp_width": 8}
    jatt = jget_ar_func("attention", LAG, 4, att_kw, dtype=jnp.float64)
    att_params = [np.asarray(p) for p in jatt.init(jax.random.key(4))]
    att = get_ar_func("attention", LAG, 4, att_kw, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(
        att.apply_codes(torch.tensor(codes), [torch.tensor(p) for p in att_params]).numpy(),
        np.asarray(jatt.apply_codes(att_params, codes)), rtol=1e-10)
    with pytest.raises(ValueError, match="af_kwargs"):
        get_ar_func("stop", LAG, 4, {"num_filters": 3}, device="cpu")


def test_cnn_init_shapes_match_bear_tpu():
    jar, params, _, ar, _ = _setup(5)
    fresh = ar.init(torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in fresh] == [p.shape for p in params]
    # The normalisations of bear_tpu's init hold for the port's draw too.
    np.testing.assert_allclose((fresh[0] ** 2).sum(dim=(0, 1)).numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose((fresh[2] ** 2).sum(dim=0).numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose((fresh[4] ** 2).sum(dim=0).numpy(), 0.05 ** 2, rtol=1e-12)
    for got, want in zip(fresh[1:2] + fresh[3:4] + fresh[5:], params[1:2] + params[3:4] + params[5:]):
        np.testing.assert_array_equal(got.numpy(), want)


def test_stop_matches():
    jar = jget_ar_func("stop", LAG, 4, dtype=jnp.float64)
    ar = get_ar_func("stop", LAG, 4, dtype=torch.float64, device="cpu")
    assert isinstance(ar, StopAR) and ar.params_list() == [] and ar.init() == []
    codes = np.random.default_rng(6).integers(0, 5, size=(7, LAG)).astype(np.int8)
    oh = np.asarray(jalph.one_hot(codes, 5, jnp.float64))
    np.testing.assert_array_equal(ar.apply_codes(torch.tensor(codes)).numpy(),
                                  np.asarray(jar.apply_codes([], codes)))
    np.testing.assert_array_equal(ar(torch.tensor(oh)).numpy(), np.asarray(jar.apply([], oh)))


# --- the CNN kernel's dispatch (ops/cnn_forward.py; the kernel itself runs
# only on a card: tests/test_torch_cuda.py) ---------------------------------


class _Input:
    """What the dispatch reads of an input: its device and whether it
    requires grad (a CUDA tensor cannot be made here)."""

    def __init__(self, device, requires_grad=False):
        self.device = torch.device(device)
        self.requires_grad = requires_grad


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cnn_forward_takes_aten_on_the_cpu_bit_for_bit(grad, dtype):
    from bear_tpu_torch.ops import cnn_forward

    _, params, codes, ar, A = _setup(7, n=50)
    x = torch.nn.functional.one_hot(torch.tensor(codes).long(), A + 1).to(dtype)
    before = cnn_forward.launches
    outs = []
    for fn in (ar.forward, ar._forward_plain):
        tp = [torch.tensor(p, dtype=dtype, requires_grad=grad) for p in params]
        with torch.set_grad_enabled(grad):
            out = fn(x, tp)
        if grad:
            out.log().sum().backward()
        outs.append((out.detach(), [p.grad for p in tp]))
    (got, got_g), (want, want_g) = outs
    assert torch.equal(got, want) and got.dtype == dtype
    if grad:
        assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))
    assert cnn_forward.launches == before == 0


def test_cnn_kernel_dispatch_reads_device_type_and_grad():
    from bear_tpu_torch.models.ar_funcs import _kernel_takes

    def live(dtype=torch.float32, grad=False):
        return [torch.zeros(2, dtype=dtype, requires_grad=grad) for _ in range(8)]

    cuda = _Input("cuda")
    assert _kernel_takes(cuda, live(), None)
    assert _kernel_takes(cuda, live(torch.float64), None)
    assert not _kernel_takes(_Input("cpu"), live(), None)
    assert not _kernel_takes(cuda, live(), torch.bfloat16)
    assert not _kernel_takes(cuda, live(torch.bfloat16), None)
    # autograd would record: a parameter or the input requires grad, grad on
    assert not _kernel_takes(cuda, live(grad=True), None)
    assert not _kernel_takes(_Input("cuda", requires_grad=True), live(), None)
    with torch.no_grad():
        assert _kernel_takes(cuda, live(grad=True), None)
        assert _kernel_takes(_Input("cuda", requires_grad=True), live(), None)
    with torch.inference_mode():
        assert _kernel_takes(cuda, live(grad=True), None)


def test_cnn_compute_dtype_keeps_its_path():
    from bear_tpu_torch.ops import cnn_forward

    _, params, codes, _, A = _setup(8, n=40)
    ar16 = get_ar_func("cnn", LAG, A, KW, dtype=torch.float32, compute_dtype=torch.bfloat16,
                       device="cpu")
    tp = [torch.tensor(p, dtype=torch.float32) for p in params]
    x = torch.nn.functional.one_hot(torch.tensor(codes).long(), A + 1).float()
    before = cnn_forward.launches
    with torch.no_grad():
        got = ar16(x, tp)
        want = ar16._forward_plain(x, tp)
    assert torch.equal(got, want) and got.dtype == torch.float32
    assert cnn_forward.launches == before


def test_cnn_forward_launch_shape_and_shared_memory():
    from bear_tpu_torch.ops import cnn_forward as cf

    dna = (13, 5, 8, 96, 64)  # lag, A1, fw, nf, w1 of the lag-13 CNN
    # The scoring cell's slices (2^18 and 94,208 rows) take 64-row tiles on
    # 132 SMs; assembly's 1,024-row steps 16-row ones (64 blocks); double
    # has one tile.
    assert cf.launch_shape(1 << 18, 4, 132, *dna) == (64, 256)
    assert cf.launch_shape(94_208, 4, 132, *dna).rows == 64
    assert cf.launch_shape(1024, 4, 132, *dna).rows == 16
    assert cf.launch_shape(1, 4, 132, *dna).rows == 16
    assert cf.launch_shape(1 << 18, 8, 132, *dna) == (16, 128)
    assert cf.launch_shape(1024, 8, 132, *dna) == cf.TILES[8][-1]
    assert cf.launch_shape(2 * 132 * 64, 4, 132, *dna).rows == 64
    assert cf.launch_shape(2 * 132 * 64 - 64, 4, 132, *dna).rows == 16
    # Two 64-row float blocks of the lag-13 CNN fit an SM (228 KB, 1 KB a
    # block reserved); a tile that would not fit falls back to 16 rows.
    smem = cf.smem_bytes(64, 4, *dna)
    assert smem == 4 * (64 * 65 + (65 + 96) * 68 + 40 * 96 + 96 * 64 + 2 * 6 * 96 + 128
                        + 64 * 5 + 5)
    assert 2 * (smem + 1024) <= 228 * 1024
    protein = (20, 22, 8, 96, 64)
    assert cf.smem_bytes(64, 4, *protein) > cf.SMEM_MAX >= cf.smem_bytes(16, 4, *protein)
    assert cf.launch_shape(1 << 18, 4, 132, *protein).rows == 16
    assert cf.smem_bytes(16, 8, *dna) <= cf.SMEM_MAX
    # Wider CNNs: every filter block's activations and every hidden block
    # but one staged. 128 filters and 96 hidden units: two blocks of each.
    wide = (13, 5, 8, 128, 96)
    assert cf.smem_bytes(64, 4, *wide) == 4 * (64 * 65 + (65 + 192) * 68 + 64 * 132
                                               + 40 * 192 + 96 * 64 + 2 * 6 * 192 + 2 * 128
                                               + 96 * 5 + 5)
    assert cf.launch_shape(1 << 18, 4, 132, *wide) == (64, 256)
    assert cf.smem_bytes(16, 8, *wide) <= cf.SMEM_MAX
    # One hidden block stages nothing more: its activations reuse act.
    assert cf.smem_bytes(64, 4, 13, 5, 8, 96, 1) == smem - 4 * 63 * 5
    # Three filter blocks (up to 288 filters) fit the 64-row float tile,
    # four do not.
    assert cf.smem_bytes(64, 4, 13, 5, 8, 288, 64) <= cf.SMEM_MAX
    assert cf.smem_bytes(64, 4, 13, 5, 8, 289, 64) > cf.SMEM_MAX
    assert cf.launch_shape(1 << 18, 4, 132, 13, 5, 8, 289, 64).rows == 16


def test_cnn_forward_narrow_instance_launch_shape():
    from bear_tpu_torch.ops import cnn_forward as cf

    protein = (6, 21, 3, 30, 16)  # lag, A1, fw, nf, w1 of the protein cell's CNN
    ysd1 = (5, 5, 3, 30, 16)  # bear_cnn_bear.cfg's widths on DNA
    for widths in (protein, ysd1):
        assert cf.is_narrow(*widths[3:])
        # The scoring cells' slices (2^18 and 94,208 rows) take the 64-row
        # tile of 256 threads; assembly's steps and double the 16-row tile
        # of 128, the tiles of the padded instance.
        for n in (1 << 18, 94_208):
            assert cf.launch_shape(n, 4, 132, *widths) == cf.TILES[4][0] == (64, 256)
        assert cf.launch_shape(1024, 4, 132, *widths) == cf.TILES[4][-1] == (16, 128)
        assert cf.launch_shape(1 << 18, 8, 132, *widths) == cf.TILES[8][-1] == (16, 128)
        # Two blocks an SM (228 KB, 1 KB a block reserved).
        assert 2 * (cf.smem_bytes(64, 4, *widths) + 1024) <= 228 * 1024
    # Unpadded past 32 filters and 16 hidden units: no 96 x 64 blocks.
    assert cf.smem_bytes(64, 4, *protein) == 4 * (64 * 126 + (126 + 32) * 68 + 63 * 32 + 32 * 16
                                                  + 2 * 4 * 32 + 2 * 16 + 16 * 21 + 21)
    # The edge: 32 filters and 16 hidden units are narrow, two blocks an SM;
    # one filter or one hidden unit more takes the padded instance, one
    # block an SM here.
    assert cf.is_narrow(32, 16) and cf.is_narrow(1, 1)
    assert 2 * (cf.smem_bytes(64, 4, 6, 21, 3, 32, 16) + 1024) <= 228 * 1024
    for past in ((33, 16), (32, 17), (96, 64)):
        assert not cf.is_narrow(*past)
        assert cf.launch_shape(1 << 18, 4, 132, 6, 21, 3, *past) == (64, 256)
        assert 2 * (cf.smem_bytes(64, 4, 6, 21, 3, *past) + 1024) > 228 * 1024
    # (146,420 B: what 30 filters and 16 hidden units took padded to 96 x 64.)
    assert cf.smem_bytes(64, 4, 6, 21, 3, 33, 16) == 146_420
    # A narrow CNN whose 64-row tile does not fit shared memory takes 16 rows.
    long = (40, 21, 3, 30, 16)
    assert cf.smem_bytes(64, 4, *long) > cf.SMEM_MAX >= cf.smem_bytes(16, 4, *long)
    assert cf.launch_shape(1 << 18, 4, 132, *long) == (16, 128)


def test_cnn_forward_refuses_what_the_kernel_cannot_take():
    from bear_tpu_torch.ops import cnn_forward as cf

    def case(nf=12, w1=10, lag=LAG, dtype=torch.float32):
        ar = CNNAR(lag, 4, 4, nf, w1, dtype=dtype, device="cpu")
        return torch.zeros((3, lag, 5), dtype=dtype), ar.params_list()

    x, params = case()
    assert cf.widths(x, params) == (LAG, 5, 4, 12, 10)
    with pytest.raises(ValueError, match="CUDA card"):
        cf.cnn_probs(x, params)
    # Any width the shared memory holds: past 96 filters and 64 hidden units
    # the kernel takes more blocks.
    assert cf.widths(*case(nf=97)) == (LAG, 5, 4, 97, 10)
    assert cf.widths(*case(w1=65)) == (LAG, 5, 4, 12, 65)
    with pytest.raises(ValueError, match="shared memory"):
        cf.widths(*case(nf=2000))
    with pytest.raises(TypeError, match="one type"):
        cf.widths(x.double(), params)
    with pytest.raises(ValueError, match="scale1"):
        cf.widths(x, params[:-1] + [params[-1][:-1]])
    with pytest.raises(TypeError, match="float32 or float64"):
        cf.widths(x.half(), params)
    assert cf.widths(*case(nf=96, w1=64, dtype=torch.float64)) == (LAG, 5, 4, 96, 64)

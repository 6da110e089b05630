"""K3 (SCA cross-attention) and K4 (SA / FFN sublayers) for training: their
plain backwards, autograd entries and dropout masks against the JAX package
on the CPU.

Each kernel wrapper of ``fact_clip_tpu_torch.ops`` runs its plain PyTorch
version on CPU tensors.  At rate 0 the plain backwards and the autograd
entries are held against ``jax.vjp`` through the JAX functions with their
Pallas kernels in interpret mode (``mha_cross_attention(..., pos_grad=False)``,
``sa_sublayer``, ``ffn_sublayer``).  With dropout, K3 is held against
``jax.vjp`` of ``_mha_reference`` given the port's hash mask as its ``keep``
(the JAX oracle takes a mask, so dropout is held to JAX too), and K4 against
torch autograd of the plain forward with the same masks.  Inputs are made
with numpy from a seed and handed to both sides.  Tolerance: 1e-5 absolute
and 1e-4 relative (float32 on both sides, sums in another order).  The CUDA
kernels are held against these plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fact_clip_tpu_torch import kernel_counters
from fact_clip_tpu_torch.ops import dilated_conv, dropout, mha_attn, sa_layer

torch.set_num_threads(2)
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    """Each test runs at two intra-op threads: in a whole run the module-level
    setting above is overwritten by whichever test module is imported last
    (some set one thread), so without this the file's sums would run at
    another thread count there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(rng, shape, scale=1.0, shift=0.0):
    a = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(port, ref, err_msg=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL,
                               err_msg=err_msg)


def _seed(v):
    return torch.tensor([v], dtype=torch.int32)


# ---------------------------------------------------------------------------
# K3

B3, M3, X3, E3, CX3, H3 = 2, 10, 300, 32, 48, 4
XLEN3 = np.array([300, 179], np.int32)


def _k3_inputs(seed):
    rng = np.random.default_rng(seed)
    q = _pair(rng, (B3, M3, E3))
    x = _pair(rng, (B3, X3, CX3))
    pos = _pair(rng, (1, X3, CX3), 0.5)  # a non-zero constant key positional term
    wk, bk = _pair(rng, (CX3, E3), 0.15), _pair(rng, (E3,), 0.05)
    wv, bv = _pair(rng, (CX3, E3), 0.15), _pair(rng, (E3,), 0.05)
    g = _pair(rng, (B3, M3, E3))
    return [q, x, pos, wk, bk, wv, bv], g


def _k3_port_grads(args_t, g_t, rate=0.0, seed=None):
    """(plain backward, autograd entry) cotangents of (q, x, wk, bk, wv, bv)."""
    q, x, pos, wk, bk, wv, bv = args_t
    xl = torch.from_numpy(XLEN3)
    keep = (mha_attn.mha_dropout_mask(seed, (B3, H3 * M3, X3), rate) if rate > 0.0 else None)
    out, stats = mha_attn.mha_cross_fwd(q, x, pos, wk, bk, wv, bv, xl, num_heads=H3, rate=rate,
                                        seed=seed, with_stats=True)
    dq, dx, dpos, dwk, dbk, dwv, dbv = mha_attn.mha_cross_bwd(
        q, x, pos, wk, bk, wv, bv, xl, stats, out, g_t, num_heads=H3, keep=keep)
    assert dpos is None
    plain = [dq, dx, dwk, dbk, dwv, dbv]
    leaves = [t.clone().requires_grad_(True) for t in (q, x, wk, bk, wv, bv)]
    lq, lx, lwk, lbk, lwv, lbv = leaves
    y = mha_attn.mha_cross_attention(lq, lx, pos, lwk, lbk, lwv, lbv, xl, num_heads=H3,
                                     rate=rate, seed=seed)
    return plain, list(torch.autograd.grad(y, leaves, g_t))


def test_k3_backward_matches_jax_grad_through_the_pallas_kernel():
    """Rate 0: the plain backward and the autograd entry against jax.vjp of
    mha_cross_attention (interpret mode, pos_grad=False), every gradient."""
    from fact_clip_tpu.ops.pallas.mha_attn import mha_cross_attention

    pairs, g = _k3_inputs(0)
    j = [p[0] for p in pairs]

    def f(q, x, wk, bk, wv, bv):
        return mha_cross_attention(q, x, j[2], wk, bk, wv, bv, jnp.asarray(XLEN3), num_heads=H3,
                                   tile=128, interpret=True, pos_grad=False)

    out_j, vjp = jax.vjp(f, j[0], j[1], *j[3:])
    refs = vjp(g[0])
    plain, auto = _k3_port_grads([p[1] for p in pairs], g[1])
    for i, (a, b, r) in enumerate(zip(plain, auto, refs)):
        _close(a, r, f"plain grad {i}")
        _close(b, r, f"autograd grad {i}")


def test_k3_dropout_backward_matches_jax_vjp_of_the_reference_with_the_port_mask():
    """Rate 0.2: the JAX oracle ``_mha_reference`` takes the port's hash mask
    as ``keep``; forward and every gradient agree."""
    from fact_clip_tpu.ops.pallas.mha_attn import _mha_reference

    pairs, g = _k3_inputs(1)
    j = [p[0] for p in pairs]
    t = [p[1] for p in pairs]
    seed = _seed(123457)
    keep = dropout.dropout_mask_reference(seed, 0, (B3, H3 * M3, X3), 0.2)
    keep_j = jnp.asarray(keep.numpy().reshape(B3, H3, M3, X3))

    def f(q, x, wk, bk, wv, bv):
        return _mha_reference(q, x, j[2], wk, bk, wv, bv, jnp.asarray(XLEN3), keep_j, H3)

    out_j, vjp = jax.vjp(f, j[0], j[1], *j[3:])
    got = mha_attn.mha_cross_fwd(*t, torch.from_numpy(XLEN3), num_heads=H3, rate=0.2, seed=seed)
    _close(got, out_j)
    refs = vjp(g[0])
    plain, auto = _k3_port_grads(t, g[1], rate=0.2, seed=seed)
    for i, (a, b, r) in enumerate(zip(plain, auto, refs)):
        _close(a, r, f"plain grad {i}")
        _close(b, r, f"autograd grad {i}")
    # the mask really dropped: the output differs from the rate-0 one
    assert float((got - mha_attn.mha_cross_fwd(*t, torch.from_numpy(XLEN3),
                                                num_heads=H3)).abs().max()) > 1e-2


def test_k3_masked_keys_get_no_gradient():
    pairs, g = _k3_inputs(2)
    plain, auto = _k3_port_grads([p[1] for p in pairs], g[1], rate=0.2, seed=_seed(5))
    for dx in (plain[1], auto[1]):
        assert float(dx[1, XLEN3[1]:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# K4

def _sa_inputs(rng, B, M, E, F):
    # weights at 0.15 for E = 32, and at the same fan-in scale for wider E
    w = lambda *s: _pair(rng, s, 0.15 * (32 / E) ** 0.5)  # noqa: E731
    x, pos = _pair(rng, (B, M, E)), _pair(rng, (1, M, E), 0.5)
    sa = [w(E, E), w(E), w(E, E), w(E), w(E, E), w(E), w(E, E), w(E)]
    ln = [_pair(rng, (E,), 0.2, 1.0), _pair(rng, (E,), 0.2)]
    # hidden pre-activations kept away from 0 (|b1| >= 0.6, small x @ W1)
    b1 = (np.sign(rng.standard_normal(F)) * rng.uniform(0.6, 1.0, F)).astype(np.float32)
    ffn = [_pair(rng, (E, F), 0.02), (jnp.asarray(b1), torch.from_numpy(b1)), w(F, E), w(E)]
    return x, pos, sa, ln, ffn, _pair(rng, (B, M, E))


# (B, E, H) per token count: narrow ones, epic's (M=300, E=256, H=8) and
# egoprocel's M=200
SA_SHAPES = {11: (3, 32, 4), 40: (3, 32, 4), 300: (1, 256, 8), 200: (2, 256, 8)}


@pytest.mark.parametrize("M", [11, 40, 300, 200])
def test_k4_sa_backward_matches_jax_grad_through_the_pallas_kernel(M):
    """Rate 0: the SA plain backward and autograd entry against jax.vjp of
    sa_sublayer (interpret mode): dx, d(pos) (summed over the videos) and
    every weight and LayerNorm gradient."""
    from fact_clip_tpu.ops.pallas.sa_layer import sa_sublayer

    rng = np.random.default_rng(10 + M)
    (B, E, H), F = SA_SHAPES[M], 48
    x, pos, sa, ln, _, g = _sa_inputs(rng, B, M, E, F)
    params = [x, pos, *sa, *ln]

    def f(*a):
        return sa_sublayer(*a, num_heads=H, interpret=True)

    _, vjp = jax.vjp(f, *[p[0] for p in params])
    refs = vjp(g[0])
    t = [p[1] for p in params]
    plain = sa_layer.sa_sublayer_bwd(*t, g[1], num_heads=H)
    leaves = [a.clone().requires_grad_(True) for a in t]
    y = sa_layer.sa_sublayer(*leaves, num_heads=H)
    _close(y, f(*[p[0] for p in params]), "forward")
    auto = torch.autograd.grad(y, leaves, g[1])
    assert plain[1].shape == pos[1].shape
    for i, (a, b, r) in enumerate(zip(plain, auto, refs)):
        _close(a, r, f"plain grad {i}")
        _close(b, r, f"autograd grad {i}")


@pytest.mark.parametrize("M", [11, 40])
def test_k4_ffn_backward_matches_jax_grad_through_the_pallas_kernel(M):
    from fact_clip_tpu.ops.pallas.sa_layer import ffn_sublayer

    rng = np.random.default_rng(20 + M)
    B, E, F = 3, 32, 48
    x, _, _, ln, ffn, g = _sa_inputs(rng, B, M, E, F)
    params = [x, *ffn, *ln]

    def f(*a):
        return ffn_sublayer(*a, interpret=True)

    _, vjp = jax.vjp(f, *[p[0] for p in params])
    refs = vjp(g[0])
    t = [p[1] for p in params]
    plain = sa_layer.ffn_sublayer_bwd(*t, g[1])
    leaves = [a.clone().requires_grad_(True) for a in t]
    auto = torch.autograd.grad(sa_layer.ffn_sublayer(*leaves), leaves, g[1])
    for i, (a, b, r) in enumerate(zip(plain, auto, refs)):
        _close(a, r, f"plain grad {i}")
        _close(b, r, f"autograd grad {i}")


@pytest.mark.parametrize("narrow_pos", [False, True])
def test_k4_sa_dropout_backward_matches_autograd_of_the_plain_forward(narrow_pos):
    """Rates 0.2 (probabilities) and 0.1 (output): the plain backward and the
    autograd entry against torch autograd of the plain forward with the same
    masks.  A positional table narrower than E shifts (and takes gradient
    through) the leading channels only."""
    rng = np.random.default_rng(30)
    B, M, E, H, F = 3, 11, 32, 4, 48
    x, pos, sa, ln, _, g = _sa_inputs(rng, B, M, E, F)
    t = [x[1], pos[1][..., :20] if narrow_pos else pos[1], *[a[1] for a in sa],
         *[a[1] for a in ln]]
    seed = _seed(77)
    ka = dropout.dropout_mask_reference(seed, 0, (B, H * M, M), 0.2)
    ko = dropout.dropout_mask_reference(seed, 1, (B, M, E), 0.1)
    leaves = [a.clone().requires_grad_(True) for a in t]
    y_ref = sa_layer.sa_sublayer_reference(*leaves, num_heads=H, keep_attn=ka, keep_out=ko)
    refs = torch.autograd.grad(y_ref, leaves, g[1])
    y = sa_layer.sa_sublayer(*leaves, num_heads=H, rate_attn=0.2, rate=0.1, seed=seed)
    _close(y, y_ref.detach(), "forward")
    auto = torch.autograd.grad(y, leaves, g[1])
    plain = sa_layer.sa_sublayer_bwd(*t, g[1], num_heads=H, keep_attn=ka, keep_out=ko)
    for i, (a, b, r) in enumerate(zip(plain, auto, refs)):
        _close(a, r, f"plain grad {i}")
        _close(b, r, f"autograd grad {i}")


def test_k4_ffn_dropout_backward_matches_autograd_of_the_plain_forward():
    rng = np.random.default_rng(31)
    B, M, E, F = 3, 11, 32, 48
    x, _, _, ln, ffn, g = _sa_inputs(rng, B, M, E, F)
    t = [x[1], *[a[1] for a in ffn], *[a[1] for a in ln]]
    seed = _seed(2 ** 31 - 2)
    k1 = dropout.dropout_mask_reference(seed, 0, (B, M, F), 0.2)
    k2 = dropout.dropout_mask_reference(seed, 1, (B, M, E), 0.2)
    leaves = [a.clone().requires_grad_(True) for a in t]
    y_ref = sa_layer.ffn_sublayer_reference(*leaves, keep_hidden=k1, keep_out=k2)
    refs = torch.autograd.grad(y_ref, leaves, g[1])
    y = sa_layer.ffn_sublayer(*leaves, rate=0.2, seed=seed)
    _close(y, y_ref.detach(), "forward")
    auto = torch.autograd.grad(y, leaves, g[1])
    plain = sa_layer.ffn_sublayer_bwd(*t, g[1], keep_hidden=k1, keep_out=k2)
    for i, (a, b, r) in enumerate(zip(plain, auto, refs)):
        _close(a, r, f"plain grad {i}")
        _close(b, r, f"autograd grad {i}")


# ---------------------------------------------------------------------------
# the shared hash mask

# (K3 (B, H*M, X), SA (B, M, E, H), FFN (B, M, E, F)) at the ragged B=3, M=11
MASK_SHAPES = {"k3": (3, 8 * 11, 1100), "sa": (3, 11, 256, 8), "ffn": (3, 11, 256, 512)}


def _masks(kind, seed, rate):
    if kind == "k3":
        return (mha_attn.mha_dropout_mask(seed, MASK_SHAPES["k3"], rate),)
    B, M, E, W = MASK_SHAPES[kind]
    if kind == "sa":
        return sa_layer.sa_dropout_masks(seed, B, M, E, W, rate, rate)
    return sa_layer.ffn_dropout_masks(seed, B, M, E, W, rate)


@pytest.mark.parametrize("kind", ["k3", "sa", "ffn"])
def test_masks_keep_rate_and_values(kind):
    """Over 8 seeds the keep rate is within 0.003 of 1 - rate (>= 5 standard
    deviations at these sizes); kept values are 1 / (1 - rate)."""
    for rate in (0.2, 0.5):
        kept = total = 0
        for s in range(8):
            for m in _masks(kind, _seed(1000 + s), rate):
                assert set(torch.unique(m).tolist()) == {0.0, 1.0 / (1.0 - rate)}
                kept += int((m > 0).sum())
                total += m.numel()
        assert abs(kept / total - (1.0 - rate)) <= 0.003, (kind, rate, kept / total)


@pytest.mark.parametrize("kind", ["k3", "sa", "ffn"])
def test_masks_are_the_k1_hash_at_the_same_seed_stream_and_index(kind):
    """Each mask, flattened, is K1's layer mask with layer = stream over the
    same number of elements: one hash keyed by (seed, stream, index)."""
    seed = _seed(424242)
    for stream, m in enumerate(_masks(kind, seed, 0.2)):
        k1 = dilated_conv.mstcn_dropout_mask(seed, stream, (1, 1, m.numel()), 0.2)
        assert torch.equal(m.reshape(-1), k1.reshape(-1))


@pytest.mark.parametrize("kind", ["k3", "sa", "ffn"])
def test_masks_differ_across_seeds_and_streams(kind):
    a, b = _masks(kind, _seed(1), 0.2), _masks(kind, _seed(2), 0.2)
    for ma_, mb in zip(a, b):
        assert not torch.equal(ma_, mb)
    if len(a) == 2:  # two streams of one call: other bits over the common prefix
        n = min(a[0].numel(), a[1].numel())
        assert not torch.equal(a[0].reshape(-1)[:n], a[1].reshape(-1)[:n])


def test_backward_regenerates_the_forward_mask():
    """The masks a backward regenerates are the ones its forward applied:
    the forward with (seed, rate) equals the plain forward given the
    regenerated masks, bit for bit, for K3, SA and FFN at the ragged shapes."""
    rng = np.random.default_rng(40)
    seed = _seed(99)
    B, M, E, H, F, X = 3, 11, 32, 4, 48, 130
    x_len = torch.tensor([130, 77, 1], dtype=torch.int32)
    q, x = _pair(rng, (B, M, E))[1], _pair(rng, (B, X, 40))[1]
    wk, bk = _pair(rng, (40, E), 0.2)[1], _pair(rng, (E,), 0.1)[1]
    wv, bv = _pair(rng, (40, E), 0.2)[1], _pair(rng, (E,), 0.1)[1]
    got = mha_attn.mha_cross_fwd(q, x, None, wk, bk, wv, bv, x_len, num_heads=H, rate=0.3,
                                 seed=seed)
    keep = mha_attn.mha_dropout_mask(seed, (B, H * M, X), 0.3)
    assert torch.equal(got, mha_attn.mha_cross_attention_reference(
        q, x, None, wk, bk, wv, bv, x_len, num_heads=H, keep=keep))
    xs, pos, sa, ln, ffn, _ = _sa_inputs(rng, B, M, E, F)
    t_sa = [xs[1], pos[1], *[a[1] for a in sa], *[a[1] for a in ln]]
    ka, ko = sa_layer.sa_dropout_masks(seed, B, M, E, H, 0.3, 0.2)
    assert torch.equal(sa_layer.sa_sublayer(*t_sa, num_heads=H, rate_attn=0.3, rate=0.2,
                                            seed=seed),
                       sa_layer.sa_sublayer_reference(*t_sa, num_heads=H, keep_attn=ka,
                                                      keep_out=ko))
    t_ffn = [xs[1], *[a[1] for a in ffn], *[a[1] for a in ln]]
    k1, k2 = sa_layer.ffn_dropout_masks(seed, B, M, E, F, 0.2)
    assert torch.equal(sa_layer.ffn_sublayer(*t_ffn, rate=0.2, seed=seed),
                       sa_layer.ffn_sublayer_reference(*t_ffn, keep_hidden=k1, keep_out=k2))


def test_attention_training_wrappers_count_no_launch_on_cpu_tensors():
    before = kernel_counters()
    test_k3_masked_keys_get_no_gradient()
    test_k4_ffn_dropout_backward_matches_autograd_of_the_plain_forward()
    test_backward_regenerates_the_forward_mask()
    assert kernel_counters() == before
    assert all(v == 0 for v in kernel_counters().values())

"""The port's layers against the JAX package's layers (XLA path) on the CPU.

Each JAX module is initialised with flax, its parameters go through the JAX
package's exporter into the reference torch layout, and the port's module
loads them strictly.  Both sides get the same numpy inputs.  Where the port
module can send work to a kernel wrapper, it is run both ways (the wrapper
runs its plain version on CPU tensors).  Comparisons are on valid frames /
keys / segments; tolerance 1e-4 absolute: float32 on both sides, other
summation order.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fact_clip_tpu.models import decode as jdecode
from fact_clip_tpu.models import layers as JL
from fact_clip_tpu.ops import segments as jseg
from fact_clip_tpu.utils import torch_export as tx
from fact_clip_tpu_torch.models import decode, layers
from fact_clip_tpu_torch.ops import segments

torch.set_num_threads(2)
ATOL = 1e-4


def _load(module, export_fn, node, *args):
    sd = {}
    export_fn(sd, "m", node, *args)
    module.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                           strict=True)
    return module


def _np(t):
    return t.detach().numpy()


def test_positional_table_and_add_pos():
    np.testing.assert_allclose(layers.positional_encoding_table(37, 10).numpy(),
                               np.asarray(JL.positional_encoding_table(37, 10)), atol=1e-6)
    assert not layers.positional_encoding_table(5, 4, empty=True).any()
    x = np.random.default_rng(0).standard_normal((2, 5, 8)).astype(np.float32)
    pos = np.random.default_rng(1).standard_normal((1, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(layers.add_pos(torch.from_numpy(x), torch.from_numpy(pos))),
                               np.asarray(JL.add_pos(jnp.asarray(x), jnp.asarray(pos))))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("ln,in_map", [(False, True), (True, False)])
def test_mstcn_matches_jax(use_kernel, ln, in_map):
    rng = np.random.default_rng(0)
    B, T, D, H, O = 2, 50, 12 if in_map else 16, 16, 20
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([50, 33], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    jm = JL.MSTCN(in_dim=D, hid_dim=H, out_dim=O, num_layers=3, dropout=0.0, ln=ln, in_map=in_map)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), True)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(mask), True))
    pm = _load(layers.MSTCN(D, H, O, 3, ln=ln, in_map=in_map, use_kernel=use_kernel),
               tx._mstcn, params["params"], in_map)
    with torch.no_grad():
        got = _np(pm(torch.from_numpy(x), torch.from_numpy(lengths)))
    np.testing.assert_allclose(got[mask], ref[mask], atol=ATOL)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("X,Y", [(9, 40), (40, 9)])
def test_x2y_matches_jax(use_kernel, X, Y):
    rng = np.random.default_rng(1)
    B, Cx, Cy, d, out = 2, 16, 16, 16, 12
    x = rng.standard_normal((B, X, Cx)).astype(np.float32)
    y = rng.standard_normal((B, Y, Cy)).astype(np.float32)
    x_pos = rng.standard_normal((1, X, 8)).astype(np.float32)
    y_pos = rng.standard_normal((B, Y, Cy)).astype(np.float32)
    x_len = np.array([X, X - 4], np.int32)
    x_mask = np.arange(X)[None] < x_len[:, None]
    jm = JL.X2YMap(x_dim=Cx, y_dim=Cy, y_outdim=out, head_dim=d, dropout=0.0, kq_pos=True)
    args = [jnp.asarray(a) for a in (x, y, x_pos, y_pos, x_mask)]
    params = jm.init(jax.random.PRNGKey(1), *args)
    ref = jm.apply(params, *args)
    pm = _load(layers.X2YMap(Cx, Cy, out, d, kq_pos=True, use_kernel=use_kernel), tx._x2y,
               params["params"])
    with torch.no_grad():
        got = pm(*[torch.from_numpy(a) for a in (x, y, x_pos, y_pos, x_len)])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=ATOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mha_cross_attention_module_matches_jax(use_kernel):
    """The SCA cross-attention; with the key threshold lowered the port
    module takes the K3 wrapper (plain version on the CPU)."""
    rng = np.random.default_rng(2)
    B, M, X, E, Ck, H = 2, 7, 40, 128, 256, 8
    q = rng.standard_normal((B, M, E)).astype(np.float32)
    mem = rng.standard_normal((B, X, Ck)).astype(np.float32)
    pos = rng.standard_normal((X, Ck)).astype(np.float32)
    k_len = np.array([40, 23], np.int32)
    k_mask = np.arange(X)[None] < k_len[:, None]
    jm = JL.MultiHeadAttention(E, H)
    m = jnp.asarray(mem)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(q), m, m, key_mask=jnp.asarray(k_mask),
                     key_pos=jnp.asarray(pos))
    ref = jm.apply(params, jnp.asarray(q), m, m, key_mask=jnp.asarray(k_mask),
                   key_pos=jnp.asarray(pos))
    pm = _load(layers.MultiheadAttention(E, H, kdim=Ck, use_kernel=use_kernel,
                                         kernel_min_keys=16), tx._mha, params["params"])
    mt = torch.from_numpy(mem)
    with torch.no_grad():
        got = pm(torch.from_numpy(q), mt, mt, key_len=torch.from_numpy(k_len),
                 key_pos=torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_sa_decoder_matches_jax(use_kernel):
    rng = np.random.default_rng(3)
    B, M, E, F, H, out = 2, 8, 16, 24, 4, 20
    tgt = rng.standard_normal((B, M, E)).astype(np.float32)
    pos = rng.standard_normal((1, M, E)).astype(np.float32)
    jm = JL.SADecoder(in_dim=E, hid_dim=E, out_dim=out, num_layers=2, nhead=H, ffdim=F,
                      dropout=0.0)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(tgt), jnp.asarray(pos))
    ref = jm.apply(params, jnp.asarray(tgt), jnp.asarray(pos))
    c = types.SimpleNamespace(a="sa", a_layers=2)
    pm = _load(layers.SADecoder(E, E, out, 2, H, F, use_kernel=use_kernel), tx._abranch,
               params["params"], c)
    with torch.no_grad():
        got = pm(torch.from_numpy(tgt), torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_sca_decoder_matches_jax(use_kernel):
    rng = np.random.default_rng(4)
    B, M, E, F, H, X, Cf, out = 2, 8, 16, 24, 4, 30, 20, 20
    tgt = np.zeros((B, M, E), np.float32)
    qpos = rng.standard_normal((1, M, E)).astype(np.float32)
    mem = rng.standard_normal((B, X, Cf)).astype(np.float32)
    mpos = rng.standard_normal((X, Cf)).astype(np.float32)
    m_len = np.array([30, 17], np.int32)
    m_mask = np.arange(X)[None] < m_len[:, None]
    jm = JL.SCADecoder(in_dim=E, hid_dim=E, out_dim=out, frame_dim=Cf, num_layers=2, nhead=H,
                       ffdim=F, dropout=0.0)
    jargs = (jnp.asarray(tgt), jnp.asarray(mem))
    jkw = dict(pos=jnp.asarray(mpos), query_pos=jnp.asarray(qpos),
               memory_mask=jnp.asarray(m_mask))
    params = jm.init(jax.random.PRNGKey(4), *jargs, **jkw)
    ref = jm.apply(params, *jargs, **jkw)
    c = types.SimpleNamespace(a="sca", a_layers=2)
    pm = _load(layers.SCADecoder(E, E, out, Cf, 2, H, F, use_kernel, use_kernel), tx._abranch,
               params["params"], c)
    with torch.no_grad():
        got = pm(torch.from_numpy(tgt), torch.from_numpy(mem), pos=torch.from_numpy(mpos),
                 query_pos=torch.from_numpy(qpos), memory_len=torch.from_numpy(m_len))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)


def test_bigru_matches_jax_on_valid_steps():
    rng = np.random.default_rng(5)
    B, N, I, H = 3, 12, 10, 6
    x = rng.standard_normal((B, N, I)).astype(np.float32)
    n = np.array([12, 7, 1], np.int32)
    valid = np.arange(N)[None] < n[:, None]
    jm = JL.BiGRU(H, 2)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(valid))
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(valid)))
    pm = _load(layers.BiGRU(I, H, 2), tx._gru, params["params"])
    with torch.no_grad():
        got = _np(pm(torch.from_numpy(x), torch.from_numpy(n)))
    np.testing.assert_allclose(got[valid], ref[valid], atol=ATOL)


def test_segment_ops_match_jax():
    rng = np.random.default_rng(6)
    B, T, S = 3, 40, 6
    pred = rng.integers(0, 3, (B, T)).astype(np.int32)
    pred[0] = 1  # one segment
    lengths = np.array([40, 25, 31])
    mask = np.arange(T)[None] < lengths[:, None]
    feat = rng.standard_normal((B, T, 5)).astype(np.float32)
    sid_j, n_j = jax.vmap(lambda p, m: jseg.segment_ids_from_pred(p, m, S))(
        jnp.asarray(pred), jnp.asarray(mask))
    P_j = jax.vmap(lambda s, m: jseg.assignment_matrix(s, m, S))(sid_j, jnp.asarray(mask))
    sid, n = segments.segment_ids_from_pred(torch.from_numpy(pred), torch.from_numpy(mask), S)
    P = segments.assignment_matrix(sid, torch.from_numpy(mask), S)
    np.testing.assert_array_equal(sid.numpy(), np.asarray(sid_j))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(P.numpy(), np.asarray(P_j))
    np.testing.assert_allclose(
        segments.pool_mean(P, torch.from_numpy(feat)).numpy(),
        np.asarray(jax.vmap(jseg.pool_mean)(P_j, jnp.asarray(feat))), atol=1e-6)
    np.testing.assert_array_equal(
        segments.segment_centers(P, S).numpy(),
        np.asarray(jax.vmap(lambda p: jseg.segment_centers(p, S))(P_j)))


def test_decode_two_branch_matches_jax():
    rng = np.random.default_rng(7)
    B, T, M, C = 3, 30, 6, 5
    aclogit = rng.standard_normal((B, M, C + 1)).astype(np.float32)
    aclogit[2, :, -1] += 10.0  # video 2: every token null -> frame-branch fallback
    a2f = jax.nn.softmax(rng.standard_normal((B, T, M)), axis=-1).astype(np.float32)
    fclogit = rng.standard_normal((B, T, C)).astype(np.float32)
    token_mask = np.ones((B, M), bool)
    token_mask[1, 4:] = False
    ref = jdecode.decode_two_branch(jnp.asarray(aclogit), jnp.asarray(a2f), jnp.asarray(fclogit),
                                    0.1, jnp.asarray(token_mask))
    got = decode.decode_two_branch(torch.from_numpy(aclogit), torch.from_numpy(np.asarray(a2f)),
                                   torch.from_numpy(fclogit), 0.1, torch.from_numpy(token_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

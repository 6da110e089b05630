"""K2's flash forward, K2's flash backward's split run forward, on the CPU.

On the card the flash forward (X > 1024 keys) is one library call,
``fk_x2y_flash_fwd`` (``csrc/flash_attn.cu``), of these launches into one
workspace: the attended lengths (``sx_attn.cuh``'s prep), the packs of Wk^T
and Wv^T, the key's positional table pos @ Wk (a kMasked GEMM, where x_pos
is given), [xk | xv] as one 3xTF32 GEMM of two problems (epilogue kProj,
the table on problem 0 only, zeros past the attended length), then the
logits, softmax partials and attend per (group of <= 32 query rows, 64-key
tile, video) in f32 and the fixed-order combine, which writes attn and
probs.  Here, without a card, ``FakeK2FlashLib`` (``FakeK2SxLib`` of
``test_torch_port_k2_sx.py`` and the entry, launch for launch on the raw
memory of CPU tensors: the row groups, the tiles wholly past x_len skipped,
the partial layouts and the combine's order) stands in for the library.
The port's launch sequence (``_x2y_flash_fwd_card``) is held against JAX's
``x2y_attention`` in interpret mode at X > 1024 (its flash form) and the
plain version: X = 1100 and 2048, M = 11, 40 and 60 (query groups of 12, 20
and 32 rows), ragged x_len and x_len = 0, no, shared and per-video
positional tables; Cy = 40, Cx = d = 48 (one and a half 32-float K steps).
JAX's kernel also weighs its zero-padded key rows at x_len = 0 where X is
not a multiple of its 512-key tile (``test_torch_port_k2_tc.py``): that case
is held against the plain version only.

Tolerance: 2e-5 of max(1, the reference's largest value), as in K2's and
K3's files: the split keeps ~2^-22 of each product, f32 sums in another
order.
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_port_k2_sx import FakeK2SxLib, _close, _inputs
from test_torch_port_k6_tc import _ints, _view

from fact_clip_tpu.ops.pallas.x2y_attn import x2y_attention
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.ops import dilated_conv as dc
from fact_clip_tpu_torch.ops import x2y_attn as xa

torch.set_num_threads(2)


class FakeK2FlashLib(FakeK2SxLib):
    """``FakeK2SxLib`` (the packs, the GEMM) and the flash forward's entry:
    the lengths, the packs, the table and the projection GEMMs, then per
    (query group, 64-key tile, video) the masked logits and the tile's
    softmax partials (m, l, acc), and the combine in tile order."""

    def fk_x2y_flash_fwd(self, x, xpos, xstride, Px, yq, wk, bk, wv, bv, xlen, B, X_, Cx, M, d,
                         scale, lens, wkvp, tab, kv, part_acc, part_ml, logits, probs, attn,
                         rows, stream):
        assert d % 4 == 0 and Cx % 4 == 0 and Px % 4 == 0 and (xpos is None) == (tab is None)
        assert rows % 4 == 0 and 4 <= rows <= xa.FLASH_ROW_GROUP
        self.calls.append(("sx_prep",))  # the lengths only
        L, xl = _ints(lens, 2 * B + 1), _ints(xlen, B)
        L[:B], L[2 * B] = M, X_
        L[B:2 * B] = torch.where(xl > 0, xl.clamp(max=X_), X_)
        self.fk_k6_pack(wk, wkvp, Cx, d, 1, Cx, Cx, 0)
        self.fk_k6_pack(wv, wkvp + 4 * 2 * d * Cx, Cx, d, 1, Cx, Cx, 0)
        if xpos is not None:  # pos @ Wk on problem 0's pack
            self.fk_k6_gemm(dc._MASKED, xpos, Px, 1, 1, ctypes.addressof(ONE), Cx, wkvp, d, Cx,
                            B if xstride else 1, X_, lens + 4 * (B if xstride else 2 * B), tab,
                            d, 0, None, None, None, 0, 0, None, None, None, 0, 0, 1.0, 0)
        self.fk_k6_gemm(dc._PROJ, x, Cx, 2, 1, ctypes.addressof(TWO), Cx, wkvp, d, Cx, B, X_,
                        lens + 4 * B, kv, 2 * d, d, bk, bv, tab, d, X_ * d if xstride else 0,
                        None, None, None, 0, 0, 1.0, 0)
        return self._flash_attend(yq, kv, xlen, B, X_, M, d, scale, part_acc, part_ml, logits,
                                  probs, attn, rows)

    def _flash_attend(self, yq, kv, xlen, B, X_, M, d, scale, part_acc, part_ml, logits, probs,
                      attn, rows):
        """``flash_attn.cu::flash_attend``: the partials, then the combine."""
        xl = _ints(xlen, B)
        self.calls.append(("x2y_flash_attn", rows))
        T = xa.FLASH_KEY_TILE
        n_t = -(-X_ // T)
        KV = _view(kv, B * X_ * 2 * d).view(B, X_, 2 * d)
        YQ = _view(yq, B * M * d).view(B, M, d)
        LG = _view(logits, B * M * X_).view(B, M, X_)
        PA = _view(part_acc, B * n_t * M * d).view(B, n_t, M, d)
        PML = _view(part_ml, B * n_t * M * 2).view(B, n_t, M, 2)
        for b in range(B):
            l_b = min(int(xl[b]), X_)
            for t in range(n_t):
                keys = torch.arange(t * T, min((t + 1) * T, X_))
                for g0 in range(0, M, rows):
                    r = slice(g0, min(g0 + rows, M))
                    if l_b > 0 and t * T >= l_b:  # p = 1 on every key, xv rows zero
                        LG[b, r, t * T:t * T + len(keys)] = -1e9
                        PA[b, t, r], PML[b, t, r, 0], PML[b, t, r, 1] = 0.0, -1e9, len(keys)
                        continue
                    lg = torch.where(keys < l_b, (YQ[b, r] @ KV[b, keys, :d].t()) * scale, -1e9)
                    LG[b, r, t * T:t * T + len(keys)] = lg
                    m = lg.amax(-1)
                    p = torch.exp(lg - m[:, None])
                    nk = min(len(keys), l_b - t * T) if l_b > 0 else len(keys)
                    PA[b, t, r] = p[:, :nk] @ KV[b, keys[:nk], d:]
                    PML[b, t, r, 0], PML[b, t, r, 1] = m, p.sum(-1)
        self.calls.append(("combine",))
        mx = PML[..., 0].amax(1)  # (B, M)
        w = torch.exp(PML[..., 0] - mx[:, None])
        l_tot = (w * PML[..., 1]).sum(1).clamp_min(1e-30)
        _view(attn, B * M * d).view(B, M, d)[:] = (w[..., None] * PA).sum(1) / l_tot[..., None]
        _view(probs, B * M * X_).view(B, M, X_)[:] = (torch.exp(LG - mx[..., None])
                                                      / l_tot[..., None])
        return 0


ONE = (ctypes.c_int * 2)(0, 0)  # one segment, no shift, channel 0
TWO = (ctypes.c_int * 4)(0, 0, 0, 0)  # two problems, both on x's channels from 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK2FlashLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _calls(rows, x_pos):
    return ([("sx_prep",), ("pack", 1), ("pack", 1)] + [("gemm", dc._MASKED)] * bool(x_pos)
            + [("gemm", dc._PROJ), ("x2y_flash_attn", rows), ("combine",)])


FWD_CASES = [  # M, X, x_len, y_pos, x_pos, JAX's kernel comparable (no x_len = 0 at a ragged X)
    (11, 1100, [1100, 517, 1], "shared", False, True),
    (40, 2048, [2048, 0], "per_video", True, True),
    (60, 1100, [1100, 700], "none", "per_video", True),
    (40, 1100, [0, 1000, 64], "shared", True, False),
    (60, 2048, [0, 2048], "shared", "per_video", True),
]


@pytest.mark.parametrize("M,X,xlen,y_pos,x_pos,jax_ok", FWD_CASES)
def test_emulated_flash_forward_matches_jax_and_plain(fake, M, X, xlen, y_pos, x_pos, jax_ok):
    """The forward's launches against JAX's ``x2y_attention`` in interpret
    mode (its flash form) and the plain version: attn, probs, logits (the
    masked logits exactly -1e9; a video with x_len = 0 attends uniformly to
    all its frames)."""
    j, t = _inputs(1, M, X, xlen, y_pos, x_pos)
    got = xa._x2y_flash_fwd_card(*t)
    rows = xa.flash_rows(M)
    assert fake.calls == _calls(rows, x_pos)
    plain = xa.x2y_attention_reference(*t)
    ref = x2y_attention(*j, interpret=True) if jax_ok else plain
    for name, g, r, p in zip(("attn", "probs", "logits"), got, ref, plain):
        _close(g.numpy(), np.asarray(r), what=name)
        _close(g.numpy(), p.numpy(), what=name)
    for b, xl in enumerate(xlen):
        assert (got[2][b, :, xl:].numpy() == -1e9).all()
        if xl == 0:
            np.testing.assert_allclose(got[1][b].numpy(), 1.0 / X, rtol=1e-6)


def test_emulated_flash_projection_takes_the_table_on_the_keys_only(fake):
    """[xk | xv] in the workspace: x @ [Wk | Wv] + [bk | bv] + [pos @ Wk | 0]
    at the attended frames (all of a video with x_len = 0), zeros past them,
    against the plain projection."""
    j, t = _inputs(2, 40, 1100, [1100, 0, 300], "shared", "per_video")
    seen = {}
    xa._x2y_flash_fwd_card(*t, inspect=seen)
    y, yp, x, xp, wk, bk, wv, bv = t[:8]
    kv = torch.cat([xa.add_pos(x, xp) @ wk + bk, x @ wv + bv], -1)
    lens = torch.tensor([1100, 1100, 300])
    kv = torch.where((torch.arange(1100)[None, :] < lens[:, None])[..., None], kv, 0.0)
    _close(seen["kv"].numpy(), kv.numpy(), what="kv")
    assert not seen["kv"][2, 300:].any()


def test_emulated_flash_forward_gives_the_same_bits_twice(fake):
    """The partials sum each tile's keys in one order and the combine the
    tiles in tile order: two runs on the same inputs give the same bits."""
    _, t = _inputs(3, 60, 2048, [2048, 1500, 0], "shared", True)
    first = xa._x2y_flash_fwd_card(*t)
    second = xa._x2y_flash_fwd_card(*t)
    for name, a, b in zip(("attn", "probs", "logits"), first, second):
        assert torch.equal(a, b), name


def test_flash_row_groups():
    """The M query rows in the fewest groups of at most 32, each a multiple of
    4: 20 rows at the flagship's M=40 (two groups), 32 at Breakfast's 60, 12
    at 11, 32 at 64 and 300 (ten groups of 30 rows)."""
    assert [xa.flash_rows(M) for M in (1, 11, 32, 33, 40, 60, 64, 300)] == [4, 12, 32, 20, 20,
                                                                            32, 32, 32]
    for M in range(1, 400):
        rows = xa.flash_rows(M)
        assert rows % 4 == 0 and 4 <= rows <= xa.FLASH_ROW_GROUP
        assert -(-M // rows) == -(-M // xa.FLASH_ROW_GROUP)  # no more groups than needed


def test_emulated_flash_forward_refuses_before_any_launch(monkeypatch):
    """A width the GEMM's 16-byte rows cannot take (Cx, d or the positional
    table's width not a multiple of 4) raises NotImplementedError, and
    dropout or a gradient NotImplementedError, before the library is asked
    for (meta tensors for the card's)."""
    def no_lib():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "lib", no_lib)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    x_len = torch.empty((2,), dtype=torch.int32, device="meta")

    def args(Cx, d, Px=None):
        return (meta(2, 40, 48), None, meta(2, 1100, Cx), meta(1, 1100, Px) if Px else None,
                meta(Cx, d), meta(d), meta(Cx, d), meta(d), meta(48, d), meta(d), x_len)

    for a in (args(42, 48), args(48, 50), args(48, 48, 22)):
        with pytest.raises(NotImplementedError):
            xa.x2y_flash_fwd(*a)
    with pytest.raises(NotImplementedError):
        xa.x2y_flash_fwd(*args(48, 48), rate=0.1)

"""K7b, the blend decode, on the port's kernels, on the CPU.

On the card the blend is one library call,
``csrc/compose_decode.cu::fk_compose_blend``, of the form the library's
plan picks (``fk_compose_blend_plan``, modelled here).  Where the
token-grouped block fits in shared memory (``blend_smem``) and the
vocabulary holds 1,280 actions or more, it is two launches through a
workspace (``blend_workspace``): the first sorts each video's frames by
voting token into items of at most 32 frames that share a token and builds
the composed argmax's run table; the second walks the items with persistent blocks of 16
warps, a lane a frame, the token's q row staged once an item in table order
and scaled by (1 - w): pass A takes each verb's S_v (the fallback's pass
1), pass B the blend's values over each verb's run and their max P_v,
skipping a verb whose bound UB_v lies below the frame's lower bound for
every frame of the warp (exact pruning), and pass 2 the lowest action index
of the best verbs' runs for both outputs.  Below 1,280 actions or past its
shared memory it takes the tile form (``compose_smem``, 32 frames a block,
the lanes striding over the actions).  Here ``FakeK7bLib`` models both on
the raw memory of CPU tensors in float32 (the exps through ``torch.exp``, as the plain version
takes them): the grouping by token, the staging, the passes, the bounds and
the tie slots; the port's call (``_compose_blend_card``) is held bit for bit
against ``compose_blend_reference`` and at >= 0.999 agreement against JAX's
``blend_argmax`` in interpret mode (the threshold of
``test_torch_port_compose.py::test_plain_decode_agrees_with_the_pallas_blend_kernel``):
random votes and votes constant over segments, a video whose tokens all
predict null, w = 0, 0.1, 0.5 and 1, inputs rounded to quarters (exact
ties), ragged token masks, T not a multiple of an item, M = 1, and
vocabularies past n1 + n2 = 407 (98 x 900 -> 6,000 on the token-grouped
form; 98 x 1,599 -> 3,806 on the tile form).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k6_tc import _ints, _view
from test_torch_port_k7a import FORMS, FakeK7aLib, _pairs_vocab, run_slots, tile_fits

from fact_clip_tpu.ops.pallas import compose_decode as jcd
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.configs import epic_vocab
from fact_clip_tpu_torch.models.decode import token_probs, votes
from fact_clip_tpu_torch.ops import compose_decode as k7

torch.set_num_threads(2)
F32 = np.float32
N1, N2, N_ACT = 13, 29, 97


def blend_smem(n1, n2, n_act, nbuf=2):
    """Bytes of a token-grouped block with ``nbuf`` item buffers
    (csrc/compose_decode.cu::blend_smem): the run table, the run starts and
    verb bounds, S_v per (verb, frame), the buffers (an item's seed, its
    token's q row and Qv, 32 frames' lv rows at 16-byte strides and ln rows
    at an odd stride), the rings of items and rows ahead, the warps' bests
    of both passes, pass 2's queue, the picks and the queue's count."""
    buf = 4 + ((n_act + 6) & ~3) + ((n1 + 3) & ~3) + 32 * (((n1 + 6) & ~3) + (n2 | 1))
    floats = (run_slots(n1, n_act) + ((n1 + 16 + 5) & ~3) + 32 * n1 + nbuf * buf + 16 + 96
              + 2 * 16 * 32 + 4 * 128 + 64 + 4)
    return 4 * floats


def blend_workspace(B, T, n1, n_act, M):
    """Ints of the token-grouped form's workspace (csrc/compose_decode.cu::
    BlendWs): the run table, the run starts and verb bounds, the videos'
    items (int4, ceil(T / 32) + min(M, T) a video), the frames grouped by
    token, the tokens' Qv (B M n1) and seeds (B M int4)."""
    items = (run_slots(n1, n_act) + n1 + 1 + 16 + 1 + 3) // 4 * 4
    seeds = (items + 4 * B * (-(-T // 32) + min(M, T)) + B * T + B * M * n1 + 3) // 4 * 4
    return seeds + 4 * B * M


def _exp(x):
    """float32 exp as the plain version takes it (``torch.exp``)."""
    return torch.exp(torch.from_numpy(np.ascontiguousarray(x, dtype=F32))).numpy()


class FakeK7bLib:
    """The blend's entry: ``forms`` the block form of each call, ``items``
    the frames of each item, ``exps`` the (frame, action) values pass B
    computed, ``skipped`` the (item, verb) runs pruning skipped."""

    TILE, SLOTS = 32, 4  # frames an item (a lane each), tied verbs a warp keeps
    MARGIN, TINY = F32(1.0000152587890625), F32(1.17549435e-38)  # 1 + 2^-16, 2^-126
    GROUPED_ACTIONS = 1280  # csrc/compose_decode.cu::BL_GROUPED_ACTIONS

    def __init__(self, seed=0, grouped_actions=GROUPED_ACTIONS):
        self.calls, self.forms, self.items = [], [], []
        self.exps = self.skipped = 0
        self.rng = np.random.default_rng(seed)
        self.table = FakeK7aLib(seed=seed)
        self.grouped_actions = grouped_actions

    def plan(self, B, T, n1, n2, n_act, M):
        """csrc/compose_decode.cu::BlendPlan: (form, workspace ints), the
        token-grouped form (1) where its block fits with one item buffer at
        least and the vocabulary holds ``grouped_actions`` actions or more,
        else the tile form (2) where it fits, else 0."""
        grouped = n_act <= 65535 and blend_smem(n1, n2, n_act, 1) <= _build.MAX_SMEM
        tile = tile_fits(n1, n2, n_act)
        form = 1 if grouped and not (tile and n_act < self.grouped_actions) else 2 if tile else 0
        return form, blend_workspace(B, T, n1, n_act, M) if form == 1 else 0

    def fk_compose_blend_plan(self, B, T, n1, n2, n_act, M, out):
        out[0], out[1] = self.plan(B, T, n1, n2, n_act, M)
        return 0

    def fk_compose_blend(self, lv, ln, vids, nids, q, act, pred, fb, ws, B, T, n1, n2, n_act, M,
                         omw, w, stream):
        self.calls.append(("compose_blend",))
        LV = _view(lv, B * T * n1).view(B, T, n1).numpy()
        LN = _view(ln, B * T * n2).view(B, T, n2).numpy()
        Q = _view(q, B * M * n_act).view(B, M, n_act).numpy()
        A = _ints(act, B * T).view(B, T).numpy()
        P = _ints(pred, B * T).view(B, T).numpy()
        FB = _ints(fb, B * T).view(B, T).numpy()
        V, N = _ints(vids, n_act).numpy(), _ints(nids, n_act).numpy()
        omw, w = F32(omw), F32(w)
        form = FORMS.get(self.plan(B, T, n1, n2, n_act, M)[0])
        assert form is not None, "the wrapper refuses what no form takes"
        self.forms.append(form)
        if form == "tile":
            for b in range(B):
                for f0 in range(0, T, self.TILE):
                    f = np.arange(f0, min(T, f0 + self.TILE))
                    s = LV[b, f][:, V] + LN[b, f][:, N]
                    p = (omw * Q[b, A[b, f]]) + w * _exp(s)
                    P[b, f], FB[b, f] = self._first_argmax(p), self._first_argmax(s)
            return 0
        assert ws is not None
        runs, entries, bnd = self.table._runs(V, N, n1, n2)
        ent_n = np.array([n for n, _ in entries], np.int64)
        ent_a = np.array([a for _, a in entries], np.int64)
        pruning = 0.0 <= w <= 1.0
        for b in range(B):
            for tok, frames in self._sort(A[b], M):
                self.items.append(len(frames))
                P[b, frames], FB[b, frames] = self._item(
                    LV[b, frames], LN[b, frames], Q[b, tok][ent_a], omw, w, runs, ent_n, ent_a,
                    bnd, pruning)
        return 0

    @staticmethod
    def _first_argmax(x):
        """The tile form's pick: lanes stride over the actions with a strict >,
        the shuffle prefers the lower index on equal values: the first argmax."""
        return np.argmax(x, axis=1)

    def _sort(self, act, M):
        """The first launch's items of one video: its frames grouped by token
        (tokens outside [0, M) read as the nearest), cut into runs of TILE;
        within a token the kernel's order is near frame order (a frame's
        picks do not depend on its place)."""
        tok = np.clip(act, 0, M - 1)
        for k in range(M):
            frames = np.nonzero(tok == k)[0]
            for i in range(0, len(frames), self.TILE):
                yield k, frames[i:i + self.TILE]

    def _bests(self, vals, have, shares):
        """Each warp's best value over its share of the verbs, how many verbs
        reach it and the first SLOTS of them (the kernel's Best), for every
        frame; verbs with have[v] False are left out."""
        out = []
        for vlo, vhi in shares:
            rows = vals.shape[0]
            best = np.full(rows, -np.inf, F32)
            nt = np.zeros(rows, np.int64)
            cands = np.zeros((rows, self.SLOTS), np.int64)
            for v in range(vlo, vhi):
                if not have[v]:
                    continue
                x = vals[:, v]
                new = (nt == 0) | (x > best)
                tie = ~new & (x == best)
                slot = tie & (nt < self.SLOTS)
                cands[slot, nt[slot]] = v
                nt = np.where(new, 1, nt + tie)
                cands[new, 0] = v
                best = np.where(new, x, best)
            out.append((best, nt, cands))
        return out

    def _item(self, lv, ln, qraw, omw, w, runs, ent_n, ent_a, bnd, pruning):
        """One item: its frames' (blend, fallback) picks; qraw the token's q in
        table order, q' = fl(omw q)."""
        rows, n1 = lv.shape
        qs = omw * qraw
        shares = list(zip(bnd[:-1], bnd[1:]))
        nonempty = np.array([runs[v] < runs[v + 1] for v in range(n1)])

        def blend(qv, s):
            return qv + w * _exp(s)

        def run_values(v, kind):
            i = slice(runs[v], runs[v + 1])
            s = lv[:, v:v + 1] + ln[:, ent_n[i]]
            return (blend(qs[i][None, :], s) if kind == "blend" else s), ent_a[i]

        # pass A: S_v, the fallback's pass 1
        S = np.full((rows, n1), -np.inf, F32)
        for v in np.nonzero(nonempty)[0]:
            S[:, v] = lv[:, v] + ln[:, ent_n[runs[v]:runs[v + 1]]].max(1)
        bests_s = self._bests(S, nonempty, shares)
        top_s = np.max([b[0] for b in bests_s], axis=0)
        # the lower bound of each frame's best blend value, and pass B
        prune = pruning and bool((qraw[:runs[n1]] >= 0).all())
        low = np.full(rows, -np.inf, F32)
        if prune:
            # Qv: fl((1 - w) max q) of each run (the first launch's maxima of
            # the raw q); the seed: the value at the token's largest q
            qv = np.array([omw * qraw[runs[v]:runs[v + 1]].max() if nonempty[v] else -np.inf
                           for v in range(n1)], F32)
            slot = int(np.argmax(qraw[:runs[n1]]))
            vq = int(np.searchsorted(runs, slot, side="right") - 1)
            low = np.maximum(blend(qs[slot], lv[:, vq] + ln[:, ent_n[slot]]), w * _exp(top_s))
        Pv = np.full((rows, n1), -np.inf, F32)
        computed = np.zeros(n1, bool)
        for v in np.nonzero(nonempty)[0]:
            if prune:
                ub = (((qv[v] + (w * _exp(S[:, v])) * self.MARGIN) * self.MARGIN) + self.TINY)
                if (ub < low).all():
                    self.skipped += 1
                    continue
            vals, _ = run_values(v, "blend")
            self.exps += vals.size
            Pv[:, v] = vals.max(1)
            computed[v] = True
        bests_p = self._bests(Pv, computed, shares)
        top_p = np.max([b[0] for b in bests_p], axis=0)
        # pass 2: the lowest action of the best verbs' runs that reaches the top
        picks = []
        for kind, bests, top in (("blend", bests_p, top_p), ("fallback", bests_s, top_s)):
            amin = np.full(rows, 2 ** 31 - 1, np.int64)
            for (best, nt, cands), (vlo, vhi) in zip(bests, shares):
                for f in range(rows):
                    if top[f] == -np.inf or nt[f] == 0 or best[f] != top[f]:
                        continue
                    verbs = cands[f, :nt[f]] if nt[f] <= self.SLOTS else range(vlo, vhi)
                    for v in verbs:
                        vals, acts = run_values(v, kind)
                        hit = acts[vals[f] == top[f]]
                        if hit.size:
                            amin[f] = min(amin[f], int(hit.min()))
            picks.append(np.where(top == -np.inf, 0, amin))
        return picks


def _install(monkeypatch, lib):
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


@pytest.fixture
def fake(monkeypatch):
    """The library with the token-grouped form taken at every vocabulary
    where it fits (most of the tests' vocabularies are below the library's
    own threshold)."""
    return _install(monkeypatch, FakeK7bLib(grouped_actions=0))


def _logp(rng, shape, coarse=False, segment=0):
    """Log-Dirichlet rows over the last axis; ``segment``: constant over runs
    of that many frames plus noise of 1e-3 (as a model's output over an
    action's frames); ``coarse``: rounded to quarters (exact ties)."""
    B, T, n = shape
    if segment:
        x = np.log(rng.dirichlet(np.ones(n), size=(B, T // segment + 1)))
        x = x[:, np.arange(T) // segment] + rng.standard_normal(shape) * 1e-3
    else:
        x = np.log(rng.dirichlet(np.ones(n), size=(B, T)))
    return (np.round(x * 4.0) / 4.0 if coarse else x).astype(F32)


def _case(seed, B=2, T=230, M=7, vocab=(N1, N2, N_ACT), coarse=False, segment=0, null=None,
          token_valid=None, pairs=False):
    """The blend's inputs as ``composed_decode`` makes them: votes from
    random a2f attention (or, with ``segment``, constant over runs of that
    many frames), the tokens' renormalised action probabilities; ``null``:
    a video whose tokens all predict null; ``token_valid``: valid tokens a
    video (a ragged token mask)."""
    rng = np.random.default_rng(seed)
    n1, n2, n_act = vocab
    vids, nids = _pairs_vocab(*vocab, seed) if pairs else epic_vocab(n1, n2, n_act, seed=seed)
    lv = _logp(rng, (B, T, n1), coarse, segment)
    ln = _logp(rng, (B, T, n2), coarse, segment)
    alogp = _logp(rng, (B, M, n_act + 1), coarse)
    if null is not None:
        alogp[null, :, :-1] -= 50.0
    alogp = torch.from_numpy(alogp)
    tmask = torch.ones((B, M), dtype=torch.bool)
    if token_valid is not None:
        tmask = torch.arange(M)[None, :] < torch.tensor(token_valid)[:, None]
    if segment:
        act = torch.from_numpy(rng.integers(0, M, (B, T // segment + 1))[:, np.arange(T) // segment])
    else:
        _, act = votes(alogp, torch.from_numpy(rng.standard_normal((B, T, M)).astype(F32)),
                       tmask)
    q = token_probs(alogp).contiguous()
    t = torch.from_numpy
    return t(lv), t(ln), t(np.ascontiguousarray(vids)), t(np.ascontiguousarray(nids)), q, \
        act.to(torch.int32).contiguous()


def _card_and_plain(args, weight):
    return k7._compose_blend_card(*args, weight), k7.compose_blend_reference(*args, weight)


def _jax(args, weight):
    lv, ln, vids, nids, q, act = (jnp.asarray(a.numpy()) for a in args)
    return [np.asarray(o) for o in jcd.blend_argmax(lv, ln, vids, nids, q, act, weight, tile=64,
                                                   interpret=True)]


def _equal(got, plain):
    for g, p in zip(got, plain):
        assert g.dtype == torch.int32 and g.shape == p.shape
        np.testing.assert_array_equal(g.numpy(), p.numpy())


@pytest.mark.parametrize("weight", [0.0, 0.1, 0.5, 1.0])
def test_emulated_k7b_equals_the_plain_blend(fake, weight):
    """Random votes (neighbouring frames rarely share a token), video 1's
    tokens all predicting null: both outputs equal the plain version's bit
    for bit, and JAX's ``blend_argmax`` in interpret mode on >= 0.999 of
    the frames; the sort put every frame in exactly one item of one token."""
    args = _case(1, null=1)
    got, plain = _card_and_plain(args, weight)
    assert fake.calls == [("compose_blend",)] and fake.forms == ["runs"]
    assert sum(fake.items) == 2 * 230 and max(fake.items) <= 32
    _equal(got, plain)
    for g, j in zip(got, _jax(args, weight)):
        assert float((g.numpy() == j).mean()) >= 0.999


def test_emulated_k7b_on_segment_votes(fake):
    """Votes constant over runs of 50 frames, rows constant there plus a
    little noise (a trained model's output): items fill their 32 lanes, and
    the picks are still the plain version's."""
    args = _case(2, T=400, M=9, segment=50)
    got, plain = _card_and_plain(args, 0.1)
    _equal(got, plain)
    assert np.mean(fake.items) > 24
    for g, j in zip(got, _jax(args, 0.1)):
        assert float((g.numpy() == j).mean()) >= 0.999


@pytest.mark.parametrize("weight", [0.0, 0.5])
def test_emulated_k7b_on_exact_ties(fake, weight):
    """Every log-prob rounded to quarters (a tied maximum on many frames, in
    the blend and in the fallback): every pick equals the plain one, so ties
    break to the first action index."""
    args = _case(3, coarse=True, null=0)
    got, plain = _card_and_plain(args, weight)
    _equal(got, plain)
    s = args[0][..., args[2].long()] + args[1][..., args[3].long()]
    assert float((s == s.amax(-1, keepdim=True)).sum(-1).gt(1).float().mean()) > 0.1


def test_emulated_k7b_with_ragged_tokens_and_one_token(fake):
    """Ragged token masks (7, 3 and 1 valid tokens: votes only among them),
    T = 97 (not a multiple of an item), and a call with M = 1 (every frame
    votes for the one token): the plain version's picks."""
    args = _case(4, B=3, T=97, token_valid=[7, 3, 1])
    _equal(*_card_and_plain(args, 0.5))
    assert set(args[5][2].tolist()) == {0}
    args = _case(5, T=97, M=1)
    _equal(*_card_and_plain(args, 0.1))


def test_emulated_k7b_pruning_skips_runs_and_keeps_the_picks(fake, monkeypatch):
    """At epic's vocabulary (98 x 301 -> 3,806) and weight 0.1, pruning skips
    most verbs' expfs, and the picks equal those of the tile form (every
    expf, with the same roundings; here taken at every vocabulary) and the
    plain version's, bit for bit."""
    args = _case(6, B=1, T=96, M=3, vocab=(98, 301, 3806))
    pruned = k7._compose_blend_card(*args, 0.1)
    assert fake.forms == ["runs"] and fake.skipped > 0 and fake.exps < 96 * 3806 / 4
    tile = _install(monkeypatch, FakeK7bLib(grouped_actions=65536))
    full = k7._compose_blend_card(*args, 0.1)
    assert tile.forms == ["tile"]
    _equal(pruned, full)
    _equal(pruned, k7.compose_blend_reference(*args, 0.1))


@pytest.mark.parametrize("vocab,form", [((98, 900, 6000), "runs"), ((98, 1599, 3806), "tile")])
def test_emulated_k7b_past_407_ids(fake, vocab, form):
    """Vocabularies past n1 + n2 = 407: 98 x 900 -> 6,000 on the
    token-grouped block (one item buffer, 199 KB), n1 + n2 = 1,697 at 3,806
    actions on the tile form (its last width): the plain version's picks."""
    for coarse in (False, True):
        args = _case(7, T=70, M=5, vocab=vocab, coarse=coarse, pairs=True)
        _equal(*_card_and_plain(args, 0.5))
        assert fake.forms[-1] == form


def test_k7b_shared_memory_workspace_and_refusals(monkeypatch):
    """Epic's block is 171,280 bytes with its two item buffers (103,776 with
    one); 98 x 900 -> 6,000 takes one buffer, 98 x 1,599 -> 3,806 the tile
    form; the workspace holds the run table, the bounds, the items, the
    sorted frames and the tokens' Qv and seeds; a vocabulary below the
    library's 1,280 actions takes the tile form (one launch, no workspace)
    at any number of frames; a vocabulary
    past the tile form is refused before any launch; on CPU tensors the
    wrapper runs the plain version and counts no launch."""
    fake = _install(monkeypatch, FakeK7bLib())
    assert blend_smem(98, 301, 3806) == 171280 and blend_smem(98, 301, 3806, 1) == 103776
    assert blend_smem(98, 900, 6000) > _build.MAX_SMEM >= blend_smem(98, 900, 6000, 1)
    slots = (3806 + 3 * 98 + 3) // 4 * 4
    items = (slots + 98 + 18 + 3) // 4 * 4
    assert k7.blend_plan(1, 24576, 98, 301, 3806, 300) == ("runs", 63664) == (
        "runs", (items + 4 * (768 + 300) + 24576 + 300 * 98 + 3) // 4 * 4 + 4 * 300)
    assert k7.blend_plan(2, 4000, 98, 900, 6000, 60)[0] == "runs"
    assert k7.blend_plan(1, 2000, 98, 1599, 3806, 60) == ("tile", 0)
    assert k7.blend_plan(3, 1000, 13, 29, 97, 7) == ("tile", 0)
    assert k7.blend_plan(1, 24576, 98, 301, 1279, 300) == ("tile", 0)
    assert k7.blend_plan(1, 1000, 98, 301, 1280, 300)[0] == "runs"
    meta = lambda *s, dt=torch.float32: torch.empty(s, device="meta", dtype=dt)  # noqa: E731
    ids = meta(3809, dt=torch.int32)
    with pytest.raises(NotImplementedError, match="n_act=3809"):
        k7._compose_blend_card(meta(1, 64, 98), meta(1, 64, 1599), ids, ids,
                               meta(1, 3, 3809), meta(1, 64, dt=torch.int32), 0.1)
    with pytest.raises(ValueError, match="M >= 1"):
        k7._compose_blend_card(meta(1, 64, 98), meta(1, 64, 301), ids[:3806], ids[:3806],
                               meta(1, 0, 3806), meta(1, 64, dt=torch.int32), 0.1)
    assert fake.calls == []
    args = _case(8, T=40)
    _equal(*_card_and_plain(args, 0.1))
    assert fake.forms == ["tile"] and fake.items == []
    before = k7.compose_blend.launches
    out = k7.compose_blend(*args, 0.1)
    assert k7.compose_blend.launches == before and fake.calls == [("compose_blend",)]
    _equal(out, k7.compose_blend_reference(*args, 0.1))

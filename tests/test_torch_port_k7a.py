"""K7a, the composed argmax, on the port's kernel, on the CPU.

On the card the composed argmax is one library call,
``csrc/compose_decode.cu::fk_compose_argmax``, of one launch: the run-table
block where it fits in shared memory (``argmax_smem``), else the tile form
(``compose_smem``: 32 frames of one video a block, the lanes striding over
the actions, a strict > a lane and a shuffle argmax that prefers the lower
index).  The run-table blocks
build a run table from vids and nids in shared memory (the actions grouped
by verb, each run padded to a multiple of 4 entries with copies of its
first, in whatever order the atomics give), then each block (16 warps, two
frames a lane, the verbs split between the warps by entries) walks tiles
of 64 frames: pass 1 takes, for each verb, S_v = fl(lv[v] + the max of ln
over the verb's run) and keeps the best S_v and up to four verbs that
reach it; the warps' bests give S*; pass 2 scans the runs of the verbs
that reach S* (every run of the warp's share past four ties) for the
lowest action index whose fl(lv + ln) equals S*.  Here ``FakeK7aLib``
models the table, both passes, the four tie slots and the blocks' walk
over the tiles on the raw memory of CPU tensors, with float32 arithmetic,
and the
port's call (``_compose_argmax_card``) is held bit for bit against
``compose_argmax_reference`` (the plain first argmax) and at >= 0.999
agreement against JAX's ``mxu_argmax`` in interpret mode (which composes
with three-term bf16 splits): log-Dirichlet, normal and coarse inputs full
of exact ties (quarters, and integers that tie five verbs and more), an
action table shuffled out of verb order, a verb with one action and one
with none, and an all -inf row; and the vocabularies past the run-table
block: (98, 900, 6,000) and n1 + n2 = 1,697 at 3,806 actions (the tile
form), 300 actions over 2 x 2 ids (the run table, the ids read from device
memory: they do not fit a tile's room).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_k6_tc import _ints, _view

from fact_clip_tpu.ops.pallas import compose_decode as jcd
from fact_clip_tpu_torch import _build
from fact_clip_tpu_torch.configs import epic_vocab
from fact_clip_tpu_torch.ops import compose_decode as k7

torch.set_num_threads(2)
N1, N2, N_ACT = 13, 29, 97
FORMS = {1: "runs", 2: "tile"}  # the library's block forms by number (0: none fits)


def run_slots(n1, n_act):
    """Entries of the run table: each verb's run padded to a multiple of 4."""
    return (n_act + 3 * n1 + 3) // 4 * 4


def argmax_smem(n1, n2, n_act):
    """Bytes of a run-table block (csrc/compose_decode.cu::argmax_smem): the
    table, the run starts, the fill counts and the warps' bounds (padded to
    16 bytes), the warps' bests, pass 2's queue, the frames' picks and the
    queue's count, and two tiles' rows of 64 frames."""
    tile = ((64 * n1 + 7) & ~3) + ((64 * n2 + 7) & ~3)
    return (16 * ((run_slots(n1, n_act) + 2 * n1 + 16 + 5) // 4) + 8 * 16 * 32 + 16 * 128
            + 4 * 64 + 16 + 8 * tile)


def tile_fits(n1, n2, n_act):
    """The tile form's block (csrc/compose_decode.cu::tile_smem) fits."""
    return 4 * n_act + 128 * (n1 + n2) <= _build.MAX_SMEM


def argmax_form(n1, n2, n_act):
    """csrc/compose_decode.cu::argmax_form: 1, the run-table block (16-bit
    action indices); 2, the tile form; 0, neither."""
    if n_act <= 65535 and argmax_smem(n1, n2, n_act) <= _build.MAX_SMEM:
        return 1
    return 2 if tile_fits(n1, n2, n_act) else 0


class FakeK7aLib:
    """The composed argmax's entry: ``blocks`` resident blocks; ``tiles``
    lists the tiles composed, ``fallbacks`` counts the frames whose warp
    kept more than four tied verbs, ``forms`` the block form of each call
    ("runs", or "tile" past the run table's shared memory) and ``staged``
    whether its ids fit a tile's room."""

    TILE, WARPS, SLOTS = 64, 16, 4  # frames a tile, warps a block, tied verbs a warp keeps
    VERB_COST = 8  # a verb's share of a warp's work past its entries
    TILE_FORM = 32  # frames a block of the tile form

    def __init__(self, blocks=3, seed=0):
        self.calls, self.tiles, self.fallbacks = [], [], 0
        self.forms, self.staged = [], []
        self.blocks, self.rng = blocks, np.random.default_rng(seed)

    def _tile_form(self, lv, ln, vids, nids):
        """One tile-form block: lane l takes actions l, l + 32, ... with a
        strict > (its first best), then the lanes' bests reduce to the
        larger value, the lower index on equal values."""
        s = lv[:, vids] + ln[:, nids]  # (rows, n_act) float32 adds
        best_v = np.full((s.shape[0], 32), -np.inf, np.float32)
        best_i = np.full((s.shape[0], 32), -1, np.int64)
        for a in range(s.shape[1]):
            lane = a % 32
            new = (best_i[:, lane] < 0) | (s[:, a] > best_v[:, lane])
            best_v[new, lane], best_i[new, lane] = s[new, a], a
        top = best_v.max(1, keepdims=True)
        return np.where(best_v == top, best_i, 2 ** 31 - 1).min(1)

    def _runs(self, vids, nids, n1, n2):
        """(runs, entries, bnd): run v is entries[runs[v]:runs[v + 1]], a
        list of (nid, action) in a shuffled order (the kernel's is its
        atomics'; no pick depends on it), padded to a multiple
        of 4 with copies of its first; warp i takes verbs [bnd[i], bnd[i +
        1]), bnd[i] the first verb whose cost (its run's start plus
        VERB_COST a verb before it) reaches i / WARPS of the total."""
        entries, runs = [], [0]
        for v in range(n1):
            run = [(int(n), a) for a, (u, n) in enumerate(zip(vids, nids))
                   if u == v and 0 <= n < n2]
            run = [run[i] for i in self.rng.permutation(len(run))]
            run += run[:1] * (-len(run) % 4)
            entries += run
            runs.append(len(entries))
        cost = [runs[v] + self.VERB_COST * v for v in range(n1 + 1)]
        bnd = [next(v for v in range(n1 + 1) if cost[v] >= i * cost[-1] // self.WARPS)
               for i in range(self.WARPS)] + [n1]
        assert bnd == sorted(bnd)
        return runs, entries, bnd

    def fk_compose_argmax(self, lv, ln, vids, nids, out, B, T, n1, n2, n_act, stream):
        self.calls.append(("compose_argmax",))
        LV = _view(lv, B * T * n1).view(B, T, n1).numpy()
        LN = _view(ln, B * T * n2).view(B, T, n2).numpy()
        O = _ints(out, B * T).view(B, T).numpy()
        form = FORMS.get(argmax_form(n1, n2, n_act))
        assert form is not None, "the wrapper refuses what no form takes"
        self.forms.append(form)
        if form == "tile":
            V, N = _ints(vids, n_act).numpy(), _ints(nids, n_act).numpy()
            for b in range(B):
                for f0 in range(0, T, self.TILE_FORM):
                    f1 = min(T, f0 + self.TILE_FORM)
                    O[b, f0:f1] = self._tile_form(LV[b, f0:f1], LN[b, f0:f1], V, N)
            return 0
        tile = ((self.TILE * n1 + 7) & ~3) + ((self.TILE * n2 + 7) & ~3)
        self.staged.append(2 * ((n_act + 7) & ~3) <= tile)
        runs, entries, bnd = self._runs(_ints(vids, n_act).numpy(),
                                          _ints(nids, n_act).numpy(), n1, n2)
        tpv = -(-T // self.TILE)
        tiles = B * tpv
        grid = min(self.blocks, tiles)
        for q in range(grid):  # block q walks tiles q, q + grid, ...
            for k in range(q, tiles, grid):
                self.tiles.append(k)
                b, f0 = divmod(k, tpv)
                f0 *= self.TILE
                rows = min(self.TILE, T - f0)
                O[b, f0:f0 + rows] = self._tile(LV[b, f0:f0 + rows], LN[b, f0:f0 + rows],
                                                runs, entries, bnd)
        return 0

    def _tile(self, lv, ln, runs, entries, bnd):
        shares = list(zip(bnd[:-1], bnd[1:]))
        warps = [self._pass1(lv, ln, runs, entries, vlo, vhi) for vlo, vhi in shares]
        top = np.max([w[0] for w in warps], axis=0)
        amin = np.full((len(shares), lv.shape[0]), 2 ** 31 - 1, np.int64)
        for w, (vlo, vhi) in enumerate(shares):
            best, nt, cands = warps[w]
            for f in range(lv.shape[0]):
                if top[f] == -np.inf:
                    amin[w, f] = 0  # every action at -inf: the first
                    continue
                if nt[f] == 0 or best[f] != top[f]:
                    continue
                self.fallbacks += int(nt[f] > self.SLOTS)
                verbs = cands[f, :nt[f]] if nt[f] <= self.SLOTS else range(vlo, vhi)
                for v in verbs:
                    for n, a in entries[runs[v]:runs[v + 1]]:
                        if lv[f, v] + ln[f, n] == top[f]:  # float32 adds
                            amin[w, f] = min(amin[w, f], a)
        return amin.min(0)

    def _pass1(self, lv, ln, runs, entries, vlo, vhi):
        rows = lv.shape[0]
        best = np.full(rows, -np.inf, np.float32)
        nt = np.zeros(rows, np.int64)
        cands = np.zeros((rows, self.SLOTS), np.int64)
        for v in range(vlo, vhi):
            if runs[v] == runs[v + 1]:
                continue  # a verb with no action
            nouns = [n for n, _ in entries[runs[v]:runs[v + 1]]]
            sv = lv[:, v] + ln[:, nouns].max(1)
            new = (nt == 0) | (sv > best)
            tie = ~new & (sv == best)
            slot = tie & (nt < self.SLOTS)
            cands[slot, nt[slot]] = v
            nt = np.where(new, 1, nt + tie)
            cands[new, 0] = v
            best = np.where(new, sv, best)
        return best, nt, cands


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK7aLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _rows(rng, B, T, n, kind):
    if kind == "normal":
        x = rng.standard_normal((B, T, n))
    else:
        x = np.log(rng.dirichlet(np.ones(n), size=(B, T)))
    if kind == "quarters":
        x = np.round(x * 4.0) / 4.0
    elif kind == "integers":
        x = np.round(x)
    return x.astype(np.float32)


def _inputs(seed, kind, B=2, T=200, vocab=(N1, N2, N_ACT)):
    rng = np.random.default_rng(seed)
    vids, nids = epic_vocab(*vocab, seed=seed)
    return _rows(rng, B, T, vocab[0], kind), _rows(rng, B, T, vocab[1], kind), vids, nids


def _card_and_plain(lv, ln, vids, nids):
    t = torch.from_numpy
    args = (t(lv), t(ln), t(np.ascontiguousarray(vids)), t(np.ascontiguousarray(nids)))
    return k7._compose_argmax_card(*args), k7.compose_argmax_reference(*args)


def _jax(lv, ln, vids, nids):
    return np.asarray(jcd.mxu_argmax(jnp.asarray(lv), jnp.asarray(ln), jnp.asarray(vids),
                                     jnp.asarray(nids), tile=64, interpret=True))


@pytest.mark.parametrize("kind", ["dirichlet", "normal", "quarters", "integers"])
def test_emulated_k7a_equals_the_plain_first_argmax(fake, kind):
    """Bit for bit the plain version's picks, ties included (quarters and
    integers are full of exact ties; integers over 160 verbs tie five verbs
    and more in a warp's share, the fallback scan); >= 0.999 of JAX's
    ``mxu_argmax`` in interpret mode; every tile composed once by the
    blocks' walk."""
    # integers over 160 verbs: a warp's share holds ten verbs, so that five of
    # them tie
    vocab = (160, N2, 1200) if kind == "integers" else (N1, N2, N_ACT)
    lv, ln, vids, nids = _inputs(3, kind, T=230, vocab=vocab)
    got, plain = _card_and_plain(lv, ln, vids, nids)
    assert fake.calls == [("compose_argmax",)]
    assert got.dtype == torch.int32 and got.shape == (2, 230)
    assert sorted(fake.tiles) == list(range(2 * 4))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert float((got.numpy() == _jax(lv, ln, vids, nids)).mean()) >= 0.999
    if kind == "integers":
        assert fake.fallbacks > 0


def test_emulated_k7a_on_segments(fake):
    """Rows constant over segments of 150 frames (as a model's output is over
    an action's frames) plus a little noise: whole tiles share one best verb,
    the load that one warp's share takes in pass 2; still the plain picks."""
    lv, ln, vids, nids = _inputs(7, "dirichlet", T=400)
    seg = np.arange(400) // 150
    rng = np.random.default_rng(8)
    lv = (lv[:, seg * 150] + rng.standard_normal(lv.shape) * 1e-3).astype(np.float32)
    ln = (ln[:, seg * 150] + rng.standard_normal(ln.shape) * 1e-3).astype(np.float32)
    got, plain = _card_and_plain(lv, ln, vids, nids)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert len(np.unique(got.numpy()[0, :150])) <= 3


@pytest.mark.parametrize("seed", [0, 1])
def test_emulated_k7a_with_the_action_table_out_of_verb_order(fake, seed):
    """vids / nids shuffled (a user's mapping need not be sorted, as
    ``epic_vocab()`` is): still the plain version's first argmax, on coarse
    inputs full of ties too, and the same picks as JAX."""
    for kind in ("dirichlet", "quarters"):
        lv, ln, vids, nids = _inputs(seed, kind)
        perm = np.random.default_rng(seed + 10).permutation(N_ACT)
        got, plain = _card_and_plain(lv, ln, vids[perm], nids[perm])
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        assert float((got.numpy() == _jax(lv, ln, vids[perm], nids[perm])).mean()) >= 0.999


def test_emulated_k7a_with_a_verb_of_one_action_and_one_of_none(fake):
    """Verb 3 keeps no action, verb 5 one; frames where verb 5's single
    action is the best (its log-probs raised) and where the best is another:
    the plain version's picks."""
    lv, ln, vids, nids = _inputs(4, "dirichlet")
    keep = (vids != 3) & ~((vids == 5) & (np.cumsum(vids == 5) > 1))
    vids, nids = vids[keep], nids[keep]
    assert not (vids == 3).any() and (vids == 5).sum() == 1
    lv[:, ::3, 5] = 0.0
    ln[:, ::3, nids[vids == 5][0]] = 0.0
    got, plain = _card_and_plain(lv, ln, vids, nids)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    a5 = int(np.nonzero(vids == 5)[0][0])
    assert (got.numpy()[:, ::3] == a5).all()
    assert float((got.numpy() == _jax(lv, ln, vids, nids)).mean()) >= 0.999


def test_emulated_k7a_all_minus_inf_rows_pick_the_first_action(fake):
    """A frame whose verb and noun rows are all -inf (and one whose verb row
    alone is) picks action 0, as ``torch.argmax`` of an all -inf row does;
    the other frames keep the plain version's picks."""
    lv, ln, vids, nids = _inputs(5, "normal", T=70)
    lv[0, 7], ln[0, 7] = -np.inf, -np.inf
    lv[1, 40] = -np.inf
    got, plain = _card_and_plain(lv, ln, vids, nids)
    assert int(got[0, 7]) == 0 and int(got[1, 40]) == 0
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_k7a_shared_memory_and_refusals(fake):
    """Epic's 98 / 301 / 3,806 fits a run-table block (228,032 bytes: the
    table, the warps' bests, pass 2's queue and two tiles of 64 frames);
    300 actions over 2 x 2 ids (whose ids do not fit a tile's room) take
    the run table too, the ids read from device memory; a vocabulary past
    the run table takes the tile form up to 4 n_act + 128 (n1 + n2) bytes;
    one past that is refused before any launch; on CPU tensors the wrapper
    runs the plain version and counts no launch."""
    assert argmax_smem(98, 301, 3806) == 228032 <= _build.MAX_SMEM
    assert FORMS[argmax_form(98, 301, 3806)] == FORMS[argmax_form(2, 2, 300)] == "runs"
    assert FORMS[argmax_form(98, 900, 6000)] == FORMS[argmax_form(98, 1599, 3806)] == "tile"
    assert argmax_form(98, 1599, 3809) == 0
    assert k7.compose_smem(98, 1599, 3808) == 232448 == _build.MAX_SMEM
    meta = lambda *s, dt=torch.float32: torch.empty(s, device="meta", dtype=dt)  # noqa: E731
    with pytest.raises(NotImplementedError, match="n_act=60000"):
        k7._compose_argmax_card(meta(1, 64, 98), meta(1, 64, 301), meta(60000, dt=torch.int32),
                                meta(60000, dt=torch.int32))
    with pytest.raises(NotImplementedError, match="n_act=3809"):
        k7._compose_argmax_card(meta(1, 64, 98), meta(1, 64, 1599), meta(3809, dt=torch.int32),
                                meta(3809, dt=torch.int32))
    assert fake.calls == []
    lv, ln, vids, nids = _inputs(6, "dirichlet", T=40)
    t = torch.from_numpy
    before = k7.compose_argmax.launches
    out = k7.compose_argmax(t(lv), t(ln), t(vids), t(nids))
    assert k7.compose_argmax.launches == before and fake.calls == []
    np.testing.assert_array_equal(out.numpy(),
                                  k7.compose_argmax_reference(t(lv), t(ln), t(vids), t(nids)))


def _pairs_vocab(n1, n2, n_act, seed):
    """n_act actions over n1 x n2 ids, every id used, pairs repeated where
    n_act > n1 * n2 (a vocabulary of many repeated pairs)."""
    rng = np.random.default_rng(seed)
    vids = np.concatenate([np.arange(n1), rng.integers(0, n1, max(0, n_act - n1))])[:n_act]
    nids = np.concatenate([np.arange(n2), rng.integers(0, n2, max(0, n_act - n2))])[:n_act]
    return vids.astype(np.int32), rng.permutation(nids).astype(np.int32)


@pytest.mark.parametrize("vocab,form,T", [((98, 900, 6000), "tile", 70),
                                          ((98, 1599, 3806), "tile", 40),
                                          ((2, 2, 300), "runs", 150)])
def test_emulated_k7a_takes_every_vocabulary_the_tile_block_took(fake, vocab, form, T):
    """Past the run-table block (98 x 900 -> 6,000 actions; n1 + n2 = 1,697
    at 3,806 actions, the tile form's last width) and where the ids do not
    fit a tile's room (300 actions over 2 x 2 ids): the picks equal the
    plain first argmax bit for bit, on log-Dirichlet rows and on rows
    rounded to quarters (exact ties); the small vocabulary agrees with JAX's
    ``mxu_argmax``."""
    n1, n2, n_act = vocab
    for kind in ("dirichlet", "quarters"):
        rng = np.random.default_rng(17)
        vids, nids = _pairs_vocab(n1, n2, n_act, 18)
        lv, ln = _rows(rng, 2, T, n1, kind), _rows(rng, 2, T, n2, kind)
        got, plain = _card_and_plain(lv, ln, vids, nids)
        assert fake.forms[-1] == form
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
    if form == "runs":
        assert fake.staged[-1] is False
        assert float((got.numpy() == _jax(lv, ln, vids, nids)).mean()) >= 0.999

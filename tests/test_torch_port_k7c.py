"""K7c, the factored argmax, on the port's kernel, on the CPU.

On the card the factored argmax is one launch,
``csrc/compose_decode.cu::fk_factored_argmax``: persistent blocks of 16
warps, a lane a frame over tiles of 32 frames.  Each block builds once a
table of each verb's mask entries that are not -inf (its run, padded to a
multiple of 4 with copies of its first entry, in noun order; the verbs split
between the warps by entries as K7a splits them); pass 1 takes, for each
verb of a warp's share in increasing order, S_v = fl(lv[v] + max over the
run of fl(ln[n] + mvn[v, n])) and keeps the first best by a strict >; the
warps' bests reduce in warp order (v* = 0 where no verb is above -inf);
then half a warp a frame finds the first noun of v*'s maximum and writes
a_table[v*, n*].  A mask whose table does not fit the block's shared memory
is read densely, a noun at a time.  ``FakeK7cLib`` models the table, the
warps' shares, both passes and the dense form on the raw memory of CPU
tensors with float32 arithmetic; the port's call (``_factored_argmax_card``)
is held bit for bit against ``factored_argmax_reference`` and against JAX's
``factored_argmax`` in interpret mode: epic's vocabulary, a 3 x 1000 batch
at 13 / 29 / 97, quartered log-probs full of ties (ties break verb first,
then noun), a verb with no noun and all -inf frames, finite non-zero mask
entries, and a mask dense enough to take the dense form.
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
from fact_clip_tpu_torch.ops.verbnoun_compose import build_factored_tables

torch.set_num_threads(2)
WARPS, VERB_COST = 16, 8  # csrc/compose_decode.cu: AM_WARPS, AM_VERB_COST


class FakeK7cLib:
    """``fk_factored_argmax`` on the memory behind the pointers; ``calls``
    lists the launches with their form ("table" or "dense")."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def layout(n1, n2):
        """``FactoredLayout``: (fits, bytes, table slots).  Two tiles of 32
        frames' lv and ln rows, the run starts, fill counts and warp bounds,
        the warps' bests, then 6-byte table slots in what is left; it fits
        with 8 slots or more and the prologue's bitmap and prefix counts in
        one tile buffer."""
        ln_at = (32 * n1 + 7) & ~3
        tile = ln_at + ((32 * n2 + 7) & ~3)
        fixed = 4 * (2 * tile + ((2 * n1 + WARPS + 2 + 3) & ~3) + 2 * WARPS * 32)
        cap = max(_build.MAX_SMEM - fixed, 0) // 6 & ~7
        return cap >= 8 and 2 * n1 * (-(-n2 // 32)) <= tile, fixed + 6 * cap, cap

    @classmethod
    def cap(cls, n1, n2):
        return cls.layout(n1, n2)[2]

    def fk_factored_plan(self, n1, n2, out):
        out[0], out[1], out[2] = (int(x) for x in self.layout(n1, n2))
        return 0

    @staticmethod
    def runs(mvn):
        """Each verb's entries above -inf in noun order, padded to 4 with its
        first; the padded starts (scan_runs)."""
        n1 = mvn.shape[0]
        runs, nouns, vals = [0], [], []
        for v in range(n1):
            n = torch.nonzero(mvn[v] != -float("inf"))[:, 0]
            pad = (-len(n)) % 4
            n = torch.cat([n, n[:1].repeat(pad)]) if len(n) else n
            nouns.append(n)
            vals.append(mvn[v, n])
            runs.append(runs[-1] + len(n))
        return runs, nouns, vals

    @staticmethod
    def bounds(runs, n1):
        """Warp i takes verbs [bnd[i], bnd[i + 1]): the first verb whose cost
        reaches i / 16 of the total (scan_runs' bisection)."""
        bnd = []
        for i in range(WARPS):
            t = i * (runs[n1] + VERB_COST * n1) // WARPS
            bnd.append(next((v for v in range(n1) if runs[v] + VERB_COST * v >= t), n1))
        return bnd + [n1]

    def fk_factored_argmax(self, lv, ln, mvn, atab, out, B, T, n1, n2, stream):
        assert self.layout(n1, n2)[0]
        LV = _view(lv, B * T * n1).view(B * T, n1)
        LN = _view(ln, B * T * n2).view(B * T, n2)
        M = _view(mvn, n1 * n2).view(n1, n2)
        A = _ints(atab, n1 * n2).view(n1, n2)
        O = _ints(out, B * T)
        runs, nouns, vals = self.runs(M)
        dense = runs[n1] > self.cap(n1, n2)
        self.calls.append("dense" if dense else "table")
        if dense:  # every noun, a value at a time from the dense mask
            nouns = [torch.arange(n2)] * n1
            vals = [M[v] for v in range(n1)]
        bnd = self.bounds(runs, n1)
        F = B * T  # a lane a frame: every frame computes alike, whatever its tile
        wbest, wverb = [], []
        for w in range(WARPS):  # pass 1, each warp's verbs in increasing order
            best = torch.full((F,), -float("inf"))
            verb = torch.full((F,), -1, dtype=torch.int64)
            for v in range(bnd[w], bnd[w + 1]):
                if len(nouns[v]) == 0:
                    continue  # no finite entry
                m = (LN[:, nouns[v]] + vals[v]).amax(dim=-1)
                s = LV[:, v] + m
                up = s > best
                best, verb = torch.where(up, s, best), torch.where(up, v, verb)
            wbest.append(best)
            wverb.append(verb)
        bb = torch.full((F,), -float("inf"))
        vs = torch.full((F,), -1, dtype=torch.int64)
        for best, verb in zip(wbest, wverb):  # the warps in order
            up = (verb >= 0) & ((vs < 0) | (best > bb))
            bb, vs = torch.where(up, best, bb), torch.where(up, verb, vs)
        vs = vs.clamp_min(0)
        ns = torch.zeros(F, dtype=torch.int64)
        for v in vs.unique().tolist():  # v*'s first noun of its maximum
            f = torch.nonzero(vs == v)[:, 0]
            if len(nouns[v]) == 0:
                continue
            x = LN[f][:, nouns[v]] + vals[v]
            top = x.amax(dim=-1, keepdim=True)
            cand = torch.where((x == top) & (top > -float("inf")), nouns[v], n2)
            ns[f] = cand.amin(dim=-1) % n2  # none above -inf: noun 0
        O[:] = A[vs, ns]
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeK7cLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return lib


def _rows(rng, B, T, n, kind):
    x = rng.standard_normal((B, T, n)) if kind == "normal" else np.log(
        rng.dirichlet(np.ones(n), size=(B, T)))
    if kind == "quarters":
        x = np.round(x * 4.0) / 4.0
    return x.astype(np.float32)


def _inputs(seed, kind, B, T, vocab, vids=None, nids=None):
    rng = np.random.default_rng(seed)
    n1, n2, n_act = vocab
    if vids is None:
        vids, nids = epic_vocab(n1, n2, n_act, seed=seed)
    mvn, at = build_factored_tables(vids, nids, n1, n2)
    return _rows(rng, B, T, n1, kind), _rows(rng, B, T, n2, kind), mvn, at


def _check(fake, lv, ln, mvn, at, form="table"):
    t = torch.from_numpy
    args = (t(lv), t(ln), t(np.ascontiguousarray(mvn)), t(np.ascontiguousarray(at)))
    got = k7._factored_argmax_card(*args)
    assert fake.calls == [form]
    assert got.dtype == torch.int32 and got.shape == lv.shape[:2]
    np.testing.assert_array_equal(got.numpy(), k7.factored_argmax_reference(*args).numpy())
    ref = np.asarray(jcd.factored_argmax(*(jnp.asarray(a) for a in (lv, ln, mvn, at)), tile=64,
                                         interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)
    return got.numpy()


@pytest.mark.parametrize("kind", ["dirichlet", "normal", "quarters"])
def test_emulated_k7c_equals_plain_and_jax(fake, kind):
    """13 / 29 / 97, 230 frames (a last tile of 6): bit for bit the plain
    version's and JAX's picks; the quarters tie the best verb on many frames
    (the first verb wins, then its first noun)."""
    lv, ln, mvn, at = _inputs(31, kind, 2, 230, (13, 29, 97))
    _check(fake, lv, ln, mvn, at)
    if kind == "quarters":
        score = lv + (ln[..., None, :] + mvn).max(axis=-1)
        tied = (score == score.max(axis=-1, keepdims=True)).sum(axis=-1) > 1
        assert tied.mean() > 0.1


def test_emulated_k7c_at_epic_vocabulary(fake):
    """Epic's 98 verbs x 301 nouns, 3,806 actions (``epic_vocab()``), at a
    small T: the table form (3,806 entries fit)."""
    vids, nids = epic_vocab()
    lv, ln, mvn, at = _inputs(32, "dirichlet", 1, 100, (98, 301, 3806), vids, nids)
    runs, _, _ = FakeK7cLib.runs(torch.from_numpy(mvn))
    assert runs[98] <= FakeK7cLib.cap(98, 301)
    _check(fake, lv, ln, mvn, at)


def test_emulated_k7c_on_a_ragged_batch(fake):
    """3 x 1000 frames at 13 / 29 / 97 (the chip script's ragged case: the
    factored argmax takes every frame; 32 tiles a video)."""
    lv, ln, mvn, at = _inputs(33, "dirichlet", 3, 1000, (13, 29, 97))
    _check(fake, lv, ln, mvn, at)


def test_emulated_k7c_with_a_verb_of_no_noun_and_all_minus_inf_frames(fake):
    """Verb 4 has no action (its run is empty: it scores -inf); frames whose
    verb log-probs are all -inf pick verb 0 and its first noun of the max, as
    the plain version does; a frame whose only finite verb is 7 picks 7."""
    rng = np.random.default_rng(34)
    vids = rng.integers(0, 13, 97).astype(np.int32)
    vids[vids == 4] = 5
    nids = rng.integers(0, 29, 97).astype(np.int32)
    lv, ln, mvn, at = _inputs(34, "normal", 2, 70, (13, 29, 97), vids, nids)
    assert np.all(mvn[4] == -np.inf)
    lv[0, :5] = -np.inf
    lv[1, 3] = -np.inf
    lv[1, 3, 7] = 0.0
    got = _check(fake, lv, ln, mvn, at)
    v0 = np.nonzero(mvn[0] > -np.inf)[0]
    assert np.all(got[0, :5] == at[0, v0[np.argmax(ln[0, :5][:, v0], axis=-1)]])
    assert got[1, 3] in at[7]


def test_emulated_k7c_with_finite_non_zero_mask_entries(fake):
    """A mask of finite values other than 0 where the actions are: each entry
    is added to ln before the max, as the plain version adds it."""
    lv, ln, mvn, at = _inputs(35, "normal", 2, 150, (13, 29, 97))
    rng = np.random.default_rng(35)
    fin = mvn > -np.inf
    mvn[fin] = rng.standard_normal(int(fin.sum())).astype(np.float32)
    _check(fake, lv, ln, mvn, at)


def test_emulated_k7c_takes_the_dense_form_past_its_table(fake):
    """Every (verb, noun) pair finite at epic's widths: 98 x 304 padded
    entries outgrow the table, so the block reads the mask densely."""
    rng = np.random.default_rng(36)
    lv, ln = _rows(rng, 1, 40, 98, "dirichlet"), _rows(rng, 1, 40, 301, "dirichlet")
    mvn = (rng.standard_normal((98, 301)) * 0.5).astype(np.float32)
    mvn[3, ::2] = -np.inf
    at = rng.permutation(98 * 301).reshape(98, 301).astype(np.int32)
    assert 98 * 304 > FakeK7cLib.cap(98, 301)
    _check(fake, lv, ln, mvn, at, form="dense")


def test_k7c_shared_memory_and_refusals(fake, monkeypatch):
    """Epic's block: two 32-frame tiles (102,144 bytes of rows), the run
    starts, the warps' bests (107,168 bytes in all) and room for ~20,000
    entries, as the library's plan reports it; a vocabulary whose tiles do
    not fit is refused before the library is asked, one whose tiles fit but
    whose table does not (800 verbs) when the plan says so, and an a_table of
    another dtype before either; nothing launches."""
    assert k7.factored_smem(98, 301) == 102144
    assert k7.factored_plan(98, 301) == (True, 107168 + 6 * 20880, 20880)
    assert k7.factored_smem(300, 1000) > _build.MAX_SMEM
    assert k7.factored_smem(800, 100) <= _build.MAX_SMEM and not k7.factored_plan(800, 100)[0]
    meta = lambda *s, dt=torch.float32: torch.empty(s, device="meta", dtype=dt)  # noqa: E731
    for n1, n2 in ((300, 1000), (800, 100)):
        with pytest.raises(NotImplementedError, match=f"n1={n1}"):
            k7._factored_argmax_card(meta(1, 64, n1), meta(1, 64, n2), meta(n1, n2),
                                     meta(n1, n2, dt=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        k7._factored_argmax_card(meta(1, 64, 98), meta(1, 64, 301), meta(98, 301),
                                 meta(98, 301, dt=torch.int64))
    assert fake.calls == []

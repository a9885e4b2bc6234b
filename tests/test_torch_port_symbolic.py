"""Symbolic-values caching through both packages: ``TestBucketPolicy`` and
``TestSymbolicCaching`` of ``tests/test_symbolic_cache.py``, and
``TestSeqBucketing`` of ``tests/test_torch_frontend.py`` through the port's
``ThunderModule``.

Each case is written once over a namespace ``P`` and run through the JAX
package (``executors=["jax"]``) and the port on the CPU
(``executors=["torch"]``, the seat of ``jaxex``), with the checks of the
JAX package's tests; the two packages' results are then held together:
bucket arithmetic exactly, compile counts exactly, values at 1e-5 (f32, the
same program in two frameworks: elementwise ops and small matmuls summed in
another order). The gpt-tiny cases share the JAX package's initial params
(``params_from_jax``).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import thunder_tpu
import thunder_tpu.clang as jclang
from thunder_tpu.core import bucketing as jbucketing
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.models import gpt as jgpt

import thunder_tpu_torch as tt
import thunder_tpu_torch.clang as tclang
from thunder_tpu_torch.core import bucketing as tbucketing
from thunder_tpu_torch.models import gpt as tgpt

JAX = SimpleNamespace(
    name="jax", clang=jclang, bucketing=jbucketing, cache_info=thunder_tpu.cache_info,
    jit=lambda f, **k: thunder_tpu.jit(f, executors=["jax"], **k),
    value_and_grad=lambda f, **k: thunder_tpu.value_and_grad(f, executors=["jax"], **k),
)
PORT = SimpleNamespace(
    name="port", clang=tclang, bucketing=tbucketing, cache_info=tt.cache_info,
    jit=lambda f, **k: tt.jit(f, device="cpu", executors=["torch"], **k),
    value_and_grad=lambda f, **k: tt.value_and_grad(f, device="cpu", executors=["torch"], **k),
)
BOTH = [pytest.param(JAX, id="jax"), pytest.param(PORT, id="port")]
SYM = "symbolic values"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# =============================================================================
# Bucket policy
# =============================================================================


class TestBucketPolicy:
    @pytest.mark.parametrize("P", BOTH)
    def test_pow2_buckets(self, P):
        p = P.bucketing.BucketPolicy()
        assert [p.bucket(0, n) for n in (1, 2, 3, 5, 8, 9)] == [(0, 1), (1, 2), (2, 4), (4, 8), (4, 8), (8, 16)]

    @pytest.mark.parametrize("P", BOTH)
    def test_seq_multiple_buckets(self, P):
        p = P.bucketing.BucketPolicy()
        assert [p.bucket(1, n) for n in (1, 128, 129)] == [(0, 128), (0, 128), (128, 256)]

    @pytest.mark.parametrize("P", BOTH)
    def test_other_dims_exact_by_default(self, P):
        assert P.bucketing.BucketPolicy().bucket(2, 7) == (6, 7)

    @pytest.mark.parametrize("P", BOTH)
    def test_env_and_option_resolution(self, P, monkeypatch):
        monkeypatch.setenv("THUNDER_TPU_BUCKETS", "batch=4,seq=exact")
        p = P.bucketing.BucketPolicy.resolve(None)
        assert p.bucket(0, 5) == (4, 8) and p.bucket(1, 5) == (4, 5)
        assert P.bucketing.BucketPolicy.resolve({"seq": "pow2"}).bucket(1, 5) == (4, 8)  # the option wins

    @pytest.mark.parametrize("P", BOTH)
    def test_invalid_specs_rejected(self, P, monkeypatch):
        with pytest.raises(ValueError):
            P.bucketing.BucketPolicy(batch="fibonacci")
        with pytest.raises(ValueError):
            P.bucketing.BucketPolicy(seq=0)
        monkeypatch.setenv("THUNDER_TPU_BUCKETS", "bogus=pow2")
        with pytest.raises(ValueError):
            P.bucketing.BucketPolicy.resolve(None)

    @pytest.mark.parametrize("P", BOTH)
    def test_symbolic_spec_marks_and_extents(self, P):
        spec = P.bucketing.make_symbolic_spec({0: (0,)}, {0: (5, 4)}, P.bucketing.BucketPolicy())
        assert spec.marks[0][0] == (4, 8, 0) and spec.padded_extent(0) == 8
        assert spec.true_extents([np.zeros((6, 4))]) == {0: 6}

    @pytest.mark.parametrize("P", BOTH)
    def test_out_of_range_dim_rejected(self, P):
        with pytest.raises(ValueError):
            P.bucketing.make_symbolic_spec({0: (3,)}, {0: (5, 4)}, P.bucketing.BucketPolicy())

    def test_policies_agree_over_a_range(self):
        for rules in ({}, {"batch": 3, "seq": "pow2"}, {"batch": "exact", "seq": 64, "other": 5}):
            j, t = jbucketing.BucketPolicy(**rules), tbucketing.BucketPolicy(**rules)
            for d in range(3):
                assert [j.bucket(d, n) for n in range(0, 300)] == [t.bucket(d, n) for n in range(0, 300)]


# =============================================================================
# Symbolic caching end to end (each case returns what it compares)
# =============================================================================


def one_compile_per_bucket_explicit_marks(P):
    jf = P.jit(lambda x: P.clang.mul(P.clang.sin(x), 2.0), cache=SYM, symbolic_dims={0: (0,)},
               buckets={"batch": "pow2"})
    outs = []
    for b in (5, 6, 7, 8):  # all in the (4, 8] bucket
        out = _np(jf(np.ones((b, 4), np.float32)))
        assert out.shape == (b, 4)
        outs.append(out)
    info = P.cache_info(jf)
    assert info["compiles"] == 1 and info["misses"] == 1 and info["hits"] == 3
    assert info["entries"][0]["symbolic"] and info["entries"][0]["buckets"] == "leaf0.dim0∈(4,8]"
    return outs


def auto_marks_from_variation(P):
    jf = P.jit(lambda x: P.clang.add(x, 1.0), cache=SYM, buckets={"batch": "pow2"})
    for b in range(1, 9):
        assert _np(jf(np.ones((b, 3), np.float32))).shape == (b, 3)
    info = P.cache_info(jf)
    assert info["compiles"] == 4  # exact@1, then (1,2], (2,4], (4,8]
    buckets = [e["buckets"] for e in info["entries"]]
    assert buckets[0] == "exact" and any("(4,8]" in b for b in buckets)
    for b in range(1, 9):
        jf(np.ones((b, 3), np.float32))
    assert P.cache_info(jf)["compiles"] == 4
    return buckets


def masked_mean_matches_unpadded(P):
    f = lambda x: P.clang.mean(P.clang.mul(P.clang.add(x, 1.0), 2.0))  # noqa: E731
    jsym = P.jit(f, cache=SYM, symbolic_dims={0: (0,)}, buckets={"batch": "pow2"})
    jconst = P.jit(f)
    outs = []
    for b in (3, 5, 6, 7):
        x = np.random.RandomState(b).randn(b, 4).astype(np.float32)
        got = float(_np(jsym(x)))
        assert abs(got - float(_np(jconst(x)))) < 1e-6
        outs.append(np.float32(got))
    return np.array(outs)


def masked_mean_keepdim(P):
    jf = P.jit(lambda x: P.clang.mean(x, (0,), keepdim=True), cache=SYM, symbolic_dims={0: (0,)},
               buckets={"batch": "pow2"})
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = _np(jf(x))
    np.testing.assert_allclose(out, x.mean(0, keepdims=True), rtol=1e-6)
    return out


def masked_contraction_right_operand(P):
    jf = P.jit(lambda w, x: P.clang.matmul(w, P.clang.exp(x)), cache=SYM, symbolic_dims={1: (0,)},
               buckets={"batch": "pow2"})
    w, x = np.ones((5, 4), np.float32), np.ones((3, 2), np.float32)  # x padded to 4 rows; exp(0) = 1 there
    out = _np(jf(w, x))
    np.testing.assert_allclose(out, w[:, :3] @ np.exp(x), rtol=1e-6)
    return out


def empty_batch_in_bucket(P):
    jf = P.jit(lambda x: P.clang.mul(x, 2.0), cache=SYM, symbolic_dims={0: (0,)}, buckets={"batch": "pow2"})
    assert _np(jf(np.ones((0, 3), np.float32))).shape == (0, 3)
    out = _np(jf(np.ones((1, 3), np.float32)))  # the same (-1, 1] bucket
    assert out.shape == (1, 3) and P.cache_info(jf)["compiles"] == 1
    return out


def masked_amax_over_padded_dim(P):
    jf = P.jit(lambda x: P.clang.amax(x, (0,)), cache=SYM, symbolic_dims={0: (0,)}, buckets={"batch": "pow2"})
    outs = []
    for b in (5, 7):
        x = np.random.RandomState(b).randn(b, 3).astype(np.float32) - 5.0  # a padded zero would win
        out = _np(jf(x))
        np.testing.assert_allclose(out, x.max(0), rtol=1e-6)
        outs.append(out)
    return outs


def grad_crops_to_true_extents(P):
    def loss(x, w):
        return P.clang.mean(P.clang.tanh(P.clang.matmul(x, w)))

    gsym = P.value_and_grad(loss, cache=SYM, symbolic_dims={0: (0,)}, buckets={"batch": "pow2"})
    gconst = P.value_and_grad(loss)
    w = np.random.RandomState(9).randn(4, 3).astype(np.float32)
    outs = []
    for b in (3, 5, 7):
        x = np.random.RandomState(b).randn(b, 4).astype(np.float32)
        (v, gs), (vr, gr) = gsym(x, w), gconst(x, w)
        assert abs(float(_np(v)) - float(_np(vr))) < 1e-6
        for g, ref in zip(gs, gr):
            assert _np(g).shape == _np(ref).shape
            np.testing.assert_allclose(_np(g), _np(ref), atol=1e-5)
        outs.append([_np(v)] + [_np(g) for g in gs])
    return outs


def rank_change_is_exact_miss(P):
    jf = P.jit(lambda x: P.clang.neg(x), cache=SYM, symbolic_dims={0: (0,)}, buckets={"batch": "pow2"})
    jf(np.ones((2, 3), np.float32))
    jf(np.ones((4,), np.float32))  # another rank: a controlled miss
    assert P.cache_info(jf)["compiles"] == 2
    return P.cache_info(jf)["compiles"]


def fast_tier_keeps_bucket_guards(P):
    """A length learned by the O(1) tier reaches its own bucket's entry; a
    length in another bucket misses it, compiles, and is learned in turn."""
    jf = P.jit(lambda x: P.clang.mul(x, 3.0), cache=SYM, symbolic_dims={0: (0,)}, buckets={"batch": "pow2"})
    order = (5, 6, 9, 6, 12, 5, 9, 12)  # (4, 8] twice, (8, 16], then each again
    outs = []
    for b in order:
        x = np.arange(b * 2, dtype=np.float32).reshape(b, 2)
        out = _np(jf(x))
        np.testing.assert_allclose(out, 3 * x)
        outs.append(out)
    info = P.cache_info(jf)
    assert (info["compiles"], info["fast_hits"], info["slow_hits"]) == (2, 4, 2)
    return outs


SYMBOLIC_CASES = [fast_tier_keeps_bucket_guards, one_compile_per_bucket_explicit_marks, auto_marks_from_variation, masked_mean_matches_unpadded,
                  masked_mean_keepdim, masked_contraction_right_operand, empty_batch_in_bucket,
                  masked_amax_over_padded_dim, grad_crops_to_true_extents, rank_change_is_exact_miss]


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        assert a == b


class TestSymbolicCaching:
    @pytest.mark.parametrize("case", SYMBOLIC_CASES, ids=lambda c: c.__name__)
    def test_case_through_both_packages(self, case):
        _same(case(PORT), case(JAX))

    @staticmethod
    def _gpt_tiny():
        jcfg = jgpt.name_to_config("gpt-tiny")
        jparams = jgpt.init_params(jcfg, dtype=jdtypes.float32, seed=0)
        tparams = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        return jcfg, jparams, tgpt.name_to_config("gpt-tiny"), tparams

    def test_gpt_forward_bitwise_once_per_bucket(self):
        """The gpt-tiny forward over batch 1-8 at two lengths: one compile a
        bucket, equal to the exact-shape entries on the real rows (a causal
        model: the pad rows never reach them), and within 1e-5 of the JAX
        package's symbolic run. Not bit for bit as in the JAX package's own
        test: torch's CPU matmul blocks its sums by the row count, so a
        padded batch adds in another order (differences of 3e-8 seen, held
        at 1e-6)."""
        jcfg, jparams, cfg, params = self._gpt_tiny()
        fwd = lambda p, i: tgpt.forward(p, i, cfg)  # noqa: E731
        jsym = PORT.jit(fwd, cache=SYM, buckets={"batch": "pow2", "seq": 8})
        jconst = PORT.jit(fwd)
        jax_sym = JAX.jit(lambda p, i: jgpt.forward(p, i, jcfg), cache=SYM, buckets={"batch": "pow2", "seq": 8})
        rng = np.random.RandomState(0)
        for t in (8, 12):
            for b in range(1, 9):
                idx = rng.randint(0, cfg.vocab_size, (b, t)).astype(np.int64)
                out = _np(jsym(params, idx))
                assert out.shape == (b, t, cfg.padded_vocab_size)
                np.testing.assert_allclose(out, _np(jconst(params, idx)), rtol=1e-6, atol=1e-6)
                if b in (1, 3, 8):
                    np.testing.assert_allclose(out, np.asarray(jax_sym(jparams, idx.astype(np.int32))),
                                               rtol=1e-5, atol=1e-5)
        info = tt.cache_info(jsym)
        assert info["compiles"] == 8 and info["hits"] == 8  # T=8: exact@1 and 3 buckets; T=12: 4 buckets
        for t in (8, 12):
            for b in range(1, 9):
                jsym(params, rng.randint(0, cfg.vocab_size, (b, t)).astype(np.int64))
        assert tt.cache_info(jsym)["compiles"] == 8

    def test_gpt_loss_mean_exact_under_padding(self):
        """Cross-entropy's mean over a padded batch: the (B,T,V)->(B*T,V)
        reshape merges the padded dim, the mask is rebuilt in the merged
        layout and the count re-pointed at the true token count."""
        jcfg, jparams, cfg, params = self._gpt_tiny()
        jsym = PORT.jit(lambda p, i, t: tgpt.loss_fn(p, i, t, cfg), cache=SYM, buckets={"batch": "pow2", "seq": 8})
        jconst = PORT.jit(lambda p, i, t: tgpt.loss_fn(p, i, t, cfg))
        jax_sym = JAX.jit(lambda p, i, t: jgpt.loss_fn(p, i, t, jcfg), cache=SYM, buckets={"batch": "pow2", "seq": 8})
        rng = np.random.RandomState(1)
        for b in (2, 3, 5):
            idx = rng.randint(0, cfg.vocab_size, (b, 8)).astype(np.int64)
            tgt = np.roll(idx, -1, 1)
            got, ref = float(_np(jsym(params, idx, tgt))), float(_np(jconst(params, idx, tgt)))
            assert abs(got - ref) < 1e-5, (b, got, ref)
            assert abs(got - float(np.asarray(jax_sym(jparams, idx.astype(np.int32), tgt.astype(np.int32))))) < 1e-5

    def test_unmodeled_op_warns_once(self):
        """An op padmask has no rule for (a flip over the padded dim) warns
        that padding is no longer tracked, once a compile, in both."""
        for P in (PORT, JAX):
            jf = P.jit(lambda x: P.clang.sum(P.clang.flip(x, (0,)), (0,)), cache=SYM, symbolic_dims={0: (0,)},
                       buckets={"batch": "pow2"})
            with pytest.warns(UserWarning, match="flip consumes a padded dim"):
                jf(np.ones((3, 2), np.float32))

    def test_symbolic_dims_forms_agree(self):
        """``symbolic_dims`` as "all" and as a dim tuple mark what the JAX
        package marks."""
        for opt, want in (("all", "leaf0.dim0∈(2,4] leaf0.dim1∈(4,5]"), ((0,), "leaf0.dim0∈(2,4] leaf1.dim0∈(4,8]")):
            descs = []
            for P in (PORT, JAX):
                jf = P.jit(lambda x, y: (P.clang.neg(x), P.clang.neg(y)), cache=SYM, symbolic_dims=opt)
                jf(np.ones((3, 5), np.float32), np.ones((6,), np.float32))
                descs.append(P.cache_info(jf)["entries"][0]["buckets"])
            assert descs[0] == descs[1], descs
            if opt == "all":
                assert descs[0].startswith("leaf0.dim0∈(2,4]")
            else:
                assert descs[0] == want


# =============================================================================
# Sequence bucketing on the module frontend (tests/test_torch_frontend.py:379)
# =============================================================================


class Causal(nn.Module):
    def __init__(self, vocab=32, dim=16):
        super().__init__()
        self.wte = nn.Embedding(vocab, dim)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim, bias=False)
        self.head = nn.Linear(dim, vocab, bias=False)

    def forward(self, idx):
        x = self.wte(idx)
        B, T, C = x.shape
        qkv = self.qkv(x).view(B, T, 3, 2, C // 2)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        y = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.head(x + self.proj(y.transpose(1, 2).reshape(B, T, C)))


def _jit_module(pkg, m, **kw):
    if pkg == "jax":
        return thunder_tpu.jit(m, executors=["jax"], **kw)
    return tt.jit(m, device="cpu", executors=["torch"], **kw)


class TestSeqBucketing:
    @pytest.mark.parametrize("pkg", ["port", "jax"])
    def test_bucketed_cache_reuse_and_parity(self, pkg):
        torch.manual_seed(0)
        m = Causal()
        tm = _jit_module(pkg, m, seq_bucket=128)
        for t in (120, 123, 128):
            idx = torch.randint(0, 32, (2, t))
            out = tm(idx)
            assert out.shape == (2, t, 32), out.shape
            torch.testing.assert_close(out, m(idx), rtol=2e-4, atol=2e-5)
        cache = tt if pkg == "port" else thunder_tpu
        assert (cache.cache_misses(tm), cache.cache_hits(tm)) == (1, 2)

    def test_coincidental_size_output_not_cropped(self):
        torch.manual_seed(2)

        class TwoHeads(nn.Module):
            def __init__(self, vocab=32, dim=16, n_stats=128):
                super().__init__()
                self.wte = nn.Embedding(vocab, dim)
                self.head = nn.Linear(dim, vocab, bias=False)
                self.stats = nn.Linear(dim, n_stats, bias=False)  # (B, 128): 128 is the padded length

            def forward(self, idx):
                x = self.wte(idx)
                return self.head(x), self.stats(x.mean(dim=1))

        m = TwoHeads()
        idx = torch.randint(0, 32, (2, 100))
        seq_out, stats_out = _jit_module("port", m, seq_bucket=128)(idx)
        assert seq_out.shape == (2, 100, 32) and stats_out.shape == (2, 128)  # not cropped to 100
        torch.testing.assert_close(seq_out, m(idx)[0], rtol=2e-4, atol=2e-5)
        j_seq, j_stats = _jit_module("jax", m, seq_bucket=128)(idx)
        torch.testing.assert_close(seq_out, j_seq, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(stats_out, j_stats, rtol=2e-4, atol=2e-5)  # the same padded mean in both

    def test_transient_probe_failure_retries(self):
        torch.manual_seed(3)
        flag = {"fail": True}

        class LazyFail(nn.Module):
            def __init__(self, vocab=32, dim=16):
                super().__init__()
                self.wte = nn.Embedding(vocab, dim)
                self.head = nn.Linear(dim, vocab, bias=False)

            def forward(self, idx):
                from torch._subclasses.fake_tensor import FakeTensor

                x = self.wte(idx)
                if flag["fail"] and isinstance(x, FakeTensor):
                    flag["fail"] = False
                    raise RuntimeError("transient lazy init under fake mode")
                return self.head(x)

        tm = _jit_module("port", LazyFail(), seq_bucket=64)
        idx = torch.randint(0, 32, (2, 50))
        assert tm(idx).shape == (2, 50, 32)
        tm(idx)
        assert tm._seq_crop_cache and all(v is not None for v in tm._seq_crop_cache.values())

    @pytest.mark.parametrize("pkg", ["port", "jax"])
    def test_bucketed_grads_match(self, pkg):
        torch.manual_seed(1)
        m_ref, m_jit = Causal(), Causal()
        m_jit.load_state_dict(m_ref.state_dict())
        tm = _jit_module(pkg, m_jit, seq_bucket=64)
        idx = torch.randint(0, 32, (2, 50))
        tm(idx).sum().backward()
        m_ref(idx).sum().backward()
        ref = dict(m_ref.named_parameters())
        checked = 0
        for name, p in tm.named_parameters():
            if p.grad is not None:
                torch.testing.assert_close(p.grad, ref[name].grad, rtol=2e-4, atol=2e-5)
                checked += 1
        assert checked >= 3

    def test_integer_target_padding_warns_once(self):
        """An integer target padded with the default fill: one warning."""

        class WithTarget(nn.Module):
            def __init__(self):
                super().__init__()
                self.lin = nn.Linear(4, 4)

            def forward(self, x, tgt):
                return self.lin(x), tgt

        tm = _jit_module("port", WithTarget(), seq_bucket=8)
        x, tgt = torch.randn(2, 5, 4), torch.zeros(2, 5, dtype=torch.int64)
        with pytest.warns(UserWarning, match="seq_pad_value"):
            tm(x, tgt)
        out, t = tm(x, tgt)
        assert out.shape == (2, 5, 4) and t.shape == (2, 5)
        tm2 = _jit_module("port", WithTarget(), seq_bucket=8, seq_pad_value=-100)
        _, t2 = tm2(x, tgt)
        assert t2.shape == (2, 5)

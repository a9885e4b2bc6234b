"""The de-opt planner's exact-shape level (L3) through both packages, on
the CPU.

The five ``TestPlannerGuidedDeopt`` cases of ``tests/test_static_planner.py``
that price L3, written once over a namespace ``P`` and run through the JAX
package (``thunder_tpu/analysis/liveness.py``, ``resilience/deopt.py``) and
the port (``thunder_tpu_torch/analysis/liveness.py``,
``resilience/deopt.py``): ``exact_shape_scale`` as a byte ratio over the
marked leaves, the ladder's jump straight to L3 under ``oom@<3*inf`` with a
capacity between the padded and exact peaks, an unknown bucketing that
leaves L3 unprovable, and the marked inputs shrinking with the activations.

Then the probe: the same ``tanh(x @ w)`` chain, x (100, 32) symbolic in dim
0, with the capacity fixed at 62468 bytes (between the JAX package's padded
and exact peaks, and between the port's) and ``chaos="oom@<3*inf"``: both
packages compile twice and log one ``compile_deopt`` to L3 with
``skipped_levels == [1, 2]``, and their results agree within 1e-5.

The port's liveness planner rounds each tensor to 512-byte blocks, the JAX
package's does not, so peaks are compared within each package, never across.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu as ttpu
import thunder_tpu.clang as jclang
import thunder_tpu.core.prims as jprims
from thunder_tpu.analysis.liveness import exact_shape_scale as jexact_shape_scale
from thunder_tpu.analysis.liveness import predict_level_peaks as jpredict_level_peaks
from thunder_tpu.core import devices as jdevices
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.core.proxies import TensorProxy as JTensorProxy
from thunder_tpu.core.trace import TraceCtx as JTraceCtx
from thunder_tpu.core.trace import tracectx as jtracectx

import thunder_tpu_torch as tt
import thunder_tpu_torch.clang as tclang
import thunder_tpu_torch.core.prims as tprims
from thunder_tpu_torch.analysis.liveness import exact_shape_scale as texact_shape_scale
from thunder_tpu_torch.analysis.liveness import predict_level_peaks as tpredict_level_peaks
from thunder_tpu_torch.core import devices as tdevices
from thunder_tpu_torch.core import dtypes as tdtypes
from thunder_tpu_torch.core.proxies import TensorProxy as TTensorProxy
from thunder_tpu_torch.core.trace import TraceCtx as TTraceCtx
from thunder_tpu_torch.core.trace import tracectx as ttracectx

JAX = SimpleNamespace(
    name="jax", clang=jclang, prims=jprims, exact_shape_scale=jexact_shape_scale,
    predict_level_peaks=jpredict_level_peaks, devices=jdevices, dtypes=jdtypes, TensorProxy=JTensorProxy,
    TraceCtx=JTraceCtx, tracectx=jtracectx, input=lambda x: x, to_float=lambda x: float(np.asarray(x)),
    jit=lambda f, **k: ttpu.jit(f, executors=["jax"], **k))
PORT = SimpleNamespace(
    name="port", clang=tclang, prims=tprims, exact_shape_scale=texact_shape_scale,
    predict_level_peaks=tpredict_level_peaks, devices=tdevices, dtypes=tdtypes, TensorProxy=TTensorProxy,
    TraceCtx=TTraceCtx, tracectx=ttracectx, input=torch.from_numpy, to_float=lambda x: float(x),
    jit=lambda f, **k: tt.jit(f, device="cpu", **k))
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)
F32 = 4
PROBE_CAPACITY = 62468


def _t(P, shape=(4, 4)):
    return P.TensorProxy(shape=shape, dtype=P.dtypes.float32, device=P.devices.Device("cpu"))


def _chain_trace(P):
    """a, b inputs (64 B each); c = a+b; d = c*c; return d."""
    trc = P.TraceCtx()
    with P.tracectx(trc):
        a, b = _t(P), _t(P)
        trc.args = (a, b)
        c = P.clang.add(a, b)
        d = P.clang.mul(c, c)
        P.prims.python_return(d)
        trc.output = d
    return trc


def _events(path):
    return [json.loads(line) for line in open(path)]


@pytest.fixture(autouse=True)
def _no_backoff(monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_RETRY_BACKOFF_S", "0")
    monkeypatch.delenv("THUNDER_TPU_CHAOS", raising=False)
    monkeypatch.delenv("THUNDER_TPU_HBM_BYTES", raising=False)


class TestPlannerGuidedDeopt:
    @BOTH
    def test_exact_shape_scale(self, P):
        class Spec:
            marks = {0: {0: (64, 128, 0)}}

        x = _t(P, (128, 32))
        assert P.exact_shape_scale(Spec(), {0: 100}, [x]) == pytest.approx(100 / 128)
        assert P.exact_shape_scale(None, {0: 100}, [x]) is None
        assert P.exact_shape_scale(Spec(), None, [x]) is None
        assert P.exact_shape_scale(Spec(), {0: 100}, None) is None

    @BOTH
    def test_exact_shape_scale_is_a_byte_ratio(self, P):
        # Two marked dims of one leaf multiply: (100*100)/(128*128).
        class Spec2:
            marks = {0: {0: (64, 128, 0), 1: (64, 128, 1)}}

        y = _t(P, (128, 128))
        assert P.exact_shape_scale(Spec2(), {0: 100, 1: 100}, [y]) == pytest.approx((100 * 100) / (128 * 128))

        # A tiny marked leaf cannot dilute a large one: bytes weigh the mix.
        class Spec3:
            marks = {0: {0: (64, 128, 0)}, 1: {0: (0, 128, 1)}}

        big, small = _t(P, (128, 512)), _t(P, (128,))
        got = P.exact_shape_scale(Spec3(), {0: 100, 1: 10}, [big, small])
        big_b, small_b = 128 * 512 * 4, 128 * 4
        expect = (big_b * 100 / 128 + small_b * 10 / 128) / (big_b + small_b)
        assert got == pytest.approx(expect)
        assert got == pytest.approx(100 / 128, rel=0.01)

    @BOTH
    def test_ladder_jumps_to_fitting_level(self, P, monkeypatch, tmp_path):
        """oom@<3 and a capacity between the padded and exact peaks: one
        compile_deopt straight to L3, skipping L1 and L2."""
        rng = np.random.RandomState(0)
        xb = P.input(rng.randn(100, 32).astype(np.float32))
        wb = P.input(rng.randn(32, 32).astype(np.float32))

        def chain(xv, wv):
            h = P.clang.tanh(P.clang.matmul(xv, wv))
            return P.clang.sum(P.clang.mul(h, h))

        baseline = P.to_float(P.jit(chain)(xb, wb))
        probe = P.jit(chain, cache="symbolic values", symbolic_dims={0: (0,)})
        probe(xb, wb)
        pe = probe._lc_cs.cache_entries[0]
        peaks = P.predict_level_peaks(pe.computation_traces[-1], sym_spec=pe.sym_spec,
                                      true_extents=pe.last_true_extents)
        assert peaks[3] < peaks[1]
        capacity = (peaks[1] + peaks[3]) // 2
        monkeypatch.setenv("THUNDER_TPU_HBM_BYTES", str(capacity))

        log = str(tmp_path / "ev.jsonl")
        jf = P.jit(chain, cache="symbolic values", symbolic_dims={0: (0,)}, chaos="oom@<3*inf", events=log)
        assert P.to_float(jf(xb, wb)) == pytest.approx(baseline, rel=1e-5)
        assert jf._lc_cd._deopt_level == 3
        assert jf._lc_cs.compile_count == 2
        deopts = [r for r in _events(log) if r.get("kind") == "compile_deopt"]
        assert len(deopts) == 1
        assert deopts[0]["level"] == 3
        assert deopts[0]["skipped_levels"] == [1, 2]
        assert deopts[0]["predicted_peak_bytes"] == peaks[3]
        assert deopts[0]["capacity_bytes"] == capacity

    @BOTH
    def test_bucketing_unknown_forces_l3_unprovable(self, P):
        # A symbolic-cache function failing before its entry exists may hold
        # a padded trace: L3 stays unknown (never skipped).
        trc = _chain_trace(P)
        peaks = P.predict_level_peaks(trc, bucketing_unknown=True)
        assert peaks[3] is None and peaks[1] is not None
        assert P.predict_level_peaks(trc)[3] == peaks[1]

    @BOTH
    def test_l3_prediction_shrinks_marked_inputs_too(self, P):
        # L3 recompiles with exact shapes: the marked input arrives smaller
        # too, so the L3 peak undercuts inputs + scaled activations computed
        # at the padded input size.
        class Spec:
            marks = {0: {0: (64, 128, 0)}}

        trc = P.TraceCtx()
        with P.tracectx(trc):
            x = _t(P, (128, 64))
            trc.args = (x,)
            h = P.clang.mul(x, x)
            out = P.clang.sum(h)
            P.prims.python_return(out)
            trc.output = out
        peaks = P.predict_level_peaks(trc, sym_spec=Spec(), true_extents={0: 100})
        no_don = peaks[1]
        in_b = 128 * 64 * F32
        scale = 100 / 128
        expect = int(in_b * scale + (no_don - in_b) * scale)
        assert peaks[3] == expect
        assert peaks[3] < int(in_b + (no_don - in_b) * scale)


def _probe(P, tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    xb = P.input(rng.randn(100, 32).astype(np.float32))
    wb = P.input(rng.randn(32, 32).astype(np.float32))

    def chain(xv, wv):
        h = P.clang.tanh(P.clang.matmul(xv, wv))
        return P.clang.sum(P.clang.mul(h, h))

    monkeypatch.setenv("THUNDER_TPU_HBM_BYTES", str(PROBE_CAPACITY))
    log = str(tmp_path / f"{P.name}.jsonl")
    jf = P.jit(chain, cache="symbolic values", symbolic_dims={0: (0,)}, chaos="oom@<3*inf", events=log)
    out = P.to_float(jf(xb, wb))
    deopts = [(r["level"], r.get("skipped_levels"), r.get("capacity_bytes"))
              for r in _events(log) if r.get("kind") == "compile_deopt"]
    return out, jf._lc_cs.compile_count, jf._lc_cd._deopt_level, deopts


def test_probe_matches_across_packages(tmp_path, monkeypatch):
    """The de-opt probe at a fixed 62468-byte capacity: the port compiles
    as often as the JAX package and logs the same planner-guided jump."""
    jout, *jrest = _probe(JAX, tmp_path, monkeypatch)
    pout, *prest = _probe(PORT, tmp_path, monkeypatch)
    assert prest == jrest
    assert prest == [2, 3, [(3, [1, 2], PROBE_CAPACITY)]]
    assert pout == pytest.approx(jout, rel=1e-5)

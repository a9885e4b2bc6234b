"""counts.py against counts by hand at small shapes."""

from types import SimpleNamespace

import pytest

from h100bench import counts

PEAK = {"bf16_flops": 1000.0, "hbm_bytes_per_s": 100.0}


def test_causal_attention_by_hand():
    # T=3: pairs (0,0) (1,0) (1,1) (2,0) (2,1) (2,2) = 6; a pair is one
    # multiply-add of D in QK^T and one in PV: 2 products x 2 FLOP x D.
    assert counts.causal_pairs(3) == 6
    assert counts.attention_fwd_flops(1, 1, 3, 4) == 2 * 2 * 4 * 6
    assert counts.attention_fwd_flops(2, 3, 3, 4) == 6 * 96
    assert counts.attention_bwd_flops(1, 1, 3, 4) == 2 * 96
    # q, k, v read and o written, bf16: 4 x T x D x 2 bytes.
    assert counts.attention_fwd_bytes(1, 1, 3, 4) == 4 * 3 * 4 * 2
    assert counts.attention_bwd_bytes(1, 1, 3, 4) == 8 * 3 * 4 * 2


def test_bound_is_the_larger_of_the_two():
    assert counts.bound_s(1000.0, 10.0, 1000.0, 100.0) == 1.0
    assert counts.bound_s(10.0, 1000.0, 1000.0, 100.0) == 10.0


def test_model_flops_by_hand():
    dims = SimpleNamespace(layers=2, heads=1, head_size=4, n_params=110, n_embedding=10)
    B, T = 1, 3
    attn = counts.attention_fwd_flops(B, 1, T, 4)
    assert counts.forward_flops(dims, B, T) == 2 * 100 * 3 + 2 * attn
    assert counts.train_flops(dims, B, T) == 6 * 100 * 3 + 2 * 3 * attn
    fwd = max(attn / 1000.0, counts.attention_fwd_bytes(B, 1, T, 4) / 100.0)
    bwd = max(2 * attn / 1000.0, counts.attention_bwd_bytes(B, 1, T, 4) / 100.0)
    assert counts.attention_bound_s(dims, B, T, PEAK, backward=False) == pytest.approx(2 * fwd)
    assert counts.attention_bound_s(dims, B, T, PEAK, backward=True) == pytest.approx(2 * (fwd + bwd))


def test_pythia_parameter_counts():
    from h100bench import cells

    for name, n in (("pythia-1b", 1_011_781_632), ("pythia-410m", 405_334_016)):
        c = cells.load_json(cells.HERE / "configs" / f"{name}.json")
        assert cells.importlib.import_module("h100bench.families.gpt_neox").dims(c).n_params == n


def test_peak_by_card_name():
    assert counts.peak("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert counts.peak("NVIDIA A100-SXM4-40GB") is None

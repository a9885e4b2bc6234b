"""The plain reference against the port at a tiny GPT-NeoX on the CPU, both
in float32: the loss, every gradient, and an AdamW step."""

from pathlib import Path

import pytest
import torch

from h100bench import cells
from h100bench.reference import neox

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def cell():
    return cells.load_cell(cells.load_json(DATA / "bench.json"), "neox-tiny.train", root=DATA)


def _batch(cell, seed, B=3, T=40):
    pool = cells.make_pool(cell, seed, B, T + 1, "cpu")
    return pool[:, :T], pool[:, 1:]


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_loss_and_grads_match_the_port(cell, seed):
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.parallel import build_train_step

    params = cells.make_params(cell, seed, "cpu", dtype=torch.float32)
    idx, tgt = _batch(cell, seed)
    step, _ = build_train_step(cell.program_config(), params, idx, tgt)
    loss, grads = step.loss_and_grads(*tree_flatten(params)[0], idx, tgt)
    prog = dict(zip(cells.flatten(params), grads))

    leaves = {k: v.clone().requires_grad_(True) for k, v in cells.flatten(params).items()}
    tree = cells.rebuild(cell.family.layout(cell.config), leaves)
    ref_loss = neox.loss_and_grads(tree, idx, tgt, cell.config)
    assert float(loss) == pytest.approx(ref_loss, abs=2e-5)
    assert float(neox.token_losses(tree, idx, tgt, cell.config).mean()) == pytest.approx(ref_loss, abs=1e-6)
    for k, v in leaves.items():
        torch.testing.assert_close(prog[k].float(), v.grad, rtol=2e-4, atol=2e-6, msg=k)


@pytest.mark.parametrize("T", [40, 64])
def test_token_losses_match_the_ports_scoring_entry(T):
    """The score runner's entry, one loss a token under symbolic values, with
    T short of its bucket's ceiling (40) and at it (64)."""
    from h100bench.runners import score

    cell = cells.load_cell(cells.load_json(DATA / "bench.json"), "neox-tiny.score", root=DATA)
    drv = score.Runner(cell, "cpu")
    drv.params = cells.make_params(cell, 3, "cpu", dtype=torch.float32)
    drv._make_entry()
    idx, tgt = _batch(cell, 3, B=cell.traffic["batch"], T=T)
    got = drv.answer(drv.call(idx.contiguous(), tgt.contiguous()), T)
    tree = cells.rebuild(cell.family.layout(cell.config), cells.flatten(drv.params))
    want = neox.token_losses(tree, idx, tgt, cell.config)
    assert got.shape == want.shape == (cell.traffic["batch"], T)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_adamw_step_matches_the_port(cell):
    from thunder_tpu_torch.parallel import build_train_step

    o = cell.traffic["optimizer"]
    params = cells.make_params(cell, 3, "cpu", dtype=torch.float32)
    start = {k: v.clone() for k, v in cells.flatten(params).items()}
    idx, tgt = _batch(cell, 3)
    step, opt = build_train_step(cell.program_config(), params, idx, tgt, lr=o["lr"],
                                 weight_decay=o["weight_decay"], b1=o["b1"], b2=o["b2"])
    for _ in range(2):
        params, opt, _ = step(params, opt, idx, tgt)

    leaves = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    tree = cells.rebuild(cell.family.layout(cell.config), leaves)
    adam = neox.AdamW(list(leaves.values()), o["lr"], o["b1"], o["b2"], o["eps"], o["weight_decay"])
    grads = None
    for _ in range(2):
        neox.loss_and_grads(tree, idx, tgt, cell.config)
        grads = grads or cells.unit_norms(cell, ((k, v.grad) for k, v in leaves.items()))
        adam.step()
    # A unit with no gradient (the key bias off the rotary features) moves
    # by round-off under Adam, on either side: the benchmark's rule leaves
    # it out, and so does this test.
    median = sorted(grads.values())[len(grads) // 2]
    prog = dict(u for k, p in cells.flatten(params).items() for u in cell.family.units(cell.config, k, p - start[k]))
    ref = dict(u for k, p in leaves.items() for u in cell.family.units(cell.config, k, p.detach() - start[k]))
    kept = [k for k in ref if grads[k] >= 1e-3 * median]
    assert len(kept) == len(ref) - cell.config["num_hidden_layers"]
    for k in kept:
        # By norm: an element whose gradient is near eps moves by g/(|g| + eps),
        # which rounding in the gradient's last bits swings.
        assert float((prog[k] - ref[k]).norm() / ref[k].norm()) < 2e-3, k


def test_bf16_storage_leaves_a_small_update_where_it_was():
    p = torch.ones(4, requires_grad=True)
    adam = neox.AdamW([p], 3e-4, 0.9, 0.95, 1e-8, 0.1, store=torch.bfloat16)
    p.grad = torch.tensor([1.0, -1.0, 1e-3, 0.0])
    adam.step()
    assert torch.equal(p.detach(), torch.ones(4))
    q = torch.full((2,), 0.02, requires_grad=True)
    adam = neox.AdamW([q], 3e-4, 0.9, 0.95, 1e-8, 0.0, store=torch.bfloat16)
    q.grad = torch.tensor([1.0, -1.0])
    adam.step()
    assert q[0] < 0.02 < q[1] and q.detach().to(torch.bfloat16).float().equal(q.detach())

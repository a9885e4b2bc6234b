"""The port's example trainers against the JAX package, on the CPU.

The counterparts of ``tests/test_examples.py``:
``thunder_tpu_torch.examples.train`` and ``train_fsdp`` (the counterparts
of ``examples/train.py`` and ``examples/train_fsdp.py``) at the same CI
sizes, on ``--device cpu``.

- ``train`` on gpt-tiny (T=64, B=2, SGD and AdamW, seed 42): its losses
  equal those of the JAX package's ``build_train_step`` run the way
  ``examples/train.py`` runs it, on the same bf16 weights (the JAX package's
  init, given to the port through ``models.gpt.params_from_jax``) and the
  same numpy batches, within 2e-4 absolute: both train in bf16-true, and
  the two packages round bf16 intermediates apart (6e-5 and 8e-5 seen).
- ``python -m thunder_tpu_torch.examples.train --device cpu`` prints
  ``tok/s`` on its last line; without a card and without ``--device cpu``
  it raises.
- ``train_fsdp`` on llama-tiny (AdamW, global batch 8, T=64, seed 42) on
  the JAX package's weights: the single-device run (``--mesh fsdp=1``, one
  process, no group) gives the losses of the JAX package's
  ``build_train_step`` run the way ``examples/train_fsdp.py`` runs it, on
  the same numpy batches, within 2e-4 absolute (3e-5 seen). On 4 gloo ranks (they meet
  on a FileStore under the test's temporary directory, each rank's output
  in a file of its own, the weights read from a file the test writes) at
  ``--mesh fsdp=4`` and ``--mesh fsdp=2,tp=2``: every rank's losses equal
  rank 0's, and they equal the single-device run's within 2e-4 absolute
  (bf16; the reduction order changes with the mesh, 3e-5 seen).
- The claims on pythia's step: its rotary covers a quarter of the head, so
  the rope kernel (which claims full-width rotate-half only) is not on
  pythia's path; flash forward-with-lse, flash backward and CE forward and
  backward are. open_llama_3b's step claims rope too.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.models import gpt as jgpt
from thunder_tpu.parallel import build_train_step as jbuild_train_step

from thunder_tpu_torch.examples import train, train_fsdp
from thunder_tpu_torch.models import gpt as tgpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 300
ATOL = 2e-4
TRAIN_ARGS = ["--device", "cpu", "--model", "gpt-tiny", "--iters", "4", "--seq-len", "64",
              "--micro-batch-size", "2", "--warmup", "1"]
FSDP_ARGS = ["--device", "cpu", "--model", "llama-tiny", "--iters", "3", "--seq-len", "64",
             "--global-batch-size", "8"]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "WORLD_SIZE", "RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return env


def _jax_losses(args) -> list:
    """``examples/train.py``'s loop on the JAX package: the first step on
    the first batch, ``warmup`` steps, then the timed iterations' losses."""
    cfg = jgpt.name_to_config(args.model)
    params = jgpt.init_params(cfg, dtype=jdtypes.bfloat16, seed=args.seed)
    rng = np.random.RandomState(args.seed)
    idx, tgt = train.synthetic_batch(rng, cfg.vocab_size, args.micro_batch_size, args.seq_len)
    step, state = jbuild_train_step(cfg, params, idx, tgt, lr=args.lr, weight_decay=args.weight_decay,
                                    optimizer=args.optimizer)
    params, state, _ = step(params, state, idx, tgt)
    losses = []
    for i in range(args.warmup + args.iters):
        idx, tgt = train.synthetic_batch(rng, cfg.vocab_size, args.micro_batch_size, args.seq_len)
        params, state, loss = step(params, state, idx, tgt)
        if i >= args.warmup:
            losses.append(float(np.asarray(loss)))
    return losses


def _jax_fsdp_losses(args) -> list:
    """``examples/train_fsdp.py``'s loop on the JAX package, on one device:
    the first step on the first batch, then the timed iterations' losses."""
    cfg = jgpt.name_to_config(args.model)
    params = jgpt.init_params(cfg, dtype=jdtypes.bfloat16, seed=args.seed)
    rng = np.random.RandomState(args.seed)
    seq = args.seq_len or cfg.block_size
    idx, tgt = train.synthetic_batch(rng, cfg.vocab_size, args.global_batch_size, seq)
    step, state = jbuild_train_step(cfg, params, idx, tgt, lr=args.lr, weight_decay=args.weight_decay,
                                    optimizer=args.optimizer)
    params, state, _ = step(params, state, idx, tgt)
    losses = []
    for _ in range(args.iters):
        idx, tgt = train.synthetic_batch(rng, cfg.vocab_size, args.global_batch_size, seq)
        params, state, loss = step(params, state, idx, tgt)
        losses.append(float(np.asarray(loss)))
    return losses


def _shared_params(model: str, seed: int) -> dict:
    jparams = jgpt.init_params(jgpt.name_to_config(model), dtype=jdtypes.bfloat16, seed=seed)
    return tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_losses_match_jax(optimizer):
    args = train.parse_args(TRAIN_ARGS + ["--optimizer", optimizer])
    got = train.run(args, params=_shared_params(args.model, args.seed))
    want = _jax_losses(args)
    assert len(got) == args.iters == len(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _jax_example(name: str):
    """``examples/<name>.py`` loaded under a name of its own."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["train", "train_fsdp"])
def test_flags_and_defaults_match_the_jax_examples(name):
    """The same flags and defaults, plus ``--device``, which defaults to
    ``cuda``."""
    ours = {"train": train, "train_fsdp": train_fsdp}[name]
    jexample = _jax_example(name)
    got = vars(ours.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == vars(jexample.parse_args([]))
    if name == "train":
        got, want = (f(np.random.RandomState(3), 96, 2, 8) for f in (train.synthetic_batch, jexample.synthetic_batch))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:
        assert train_fsdp.parse_mesh("dp=2,fsdp=2,tp=2") == jexample.parse_mesh("dp=2,fsdp=2,tp=2")


def test_train_cli_prints_tokens_per_second(tmp_path):
    with open(tmp_path / "err", "w") as err:
        proc = subprocess.run([sys.executable, "-m", "thunder_tpu_torch.examples.train", *TRAIN_ARGS],
                              stdout=subprocess.PIPE, stderr=err, text=True, env=_env(), cwd=REPO,
                              timeout=SPAWN_TIMEOUT_S)
    log = open(tmp_path / "err").read()
    assert proc.returncode == 0, log[-3000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert "avg" in last and "s/iter" in last and "tok/s" in last
    assert [line.split(":")[0] for line in log.splitlines() if line.startswith("iter ")] == \
        [f"iter {i}" for i in range(4)]


@pytest.mark.parametrize("module", ["train", "train_fsdp"])
def test_trainers_never_fall_back_to_the_cpu(module, monkeypatch):
    """``--device`` defaults to ``cuda``; with no card the trainer raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mod = {"train": train, "train_fsdp": train_fsdp}[module]
    args = mod.parse_args(["--model", "gpt-tiny", "--iters", "1", "--seq-len", "16"]
                          + (["--mesh", "fsdp=1"] if module == "train_fsdp" else []))
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(args)


_RANK = """
import json, sys
import torch
import torch.distributed as dist
import thunder_tpu_torch.distributed as td
from thunder_tpu_torch.examples import train_fsdp
rank, world, store, out, weights = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
td.init(device="cpu", store=dist.FileStore(store, world), num_processes=world, process_id=rank)
try:
    losses = train_fsdp.run(train_fsdp.parse_args(sys.argv[6:]), params=torch.load(weights))
finally:
    td.shutdown()
json.dump(losses, open(out, "w"))
"""


def _fsdp_ranks(tmp_path, mesh: str, weights: str, world: int = 4) -> list:
    store = str(tmp_path / f"store-{mesh}")
    procs = []
    for r in range(world):
        with open(tmp_path / f"{mesh}-rank{r}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK, str(r), str(world), store, str(tmp_path / f"{mesh}-{r}.json"),
                 weights, *FSDP_ARGS, "--mesh", mesh], stdout=f, stderr=subprocess.STDOUT, env=_env(), cwd=REPO))
    try:
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, open(tmp_path / f"{mesh}-rank{r}.log").read()[-3000:]
    return [json.load(open(tmp_path / f"{mesh}-{r}.json")) for r in range(world)]


@pytest.fixture(scope="module")
def fsdp_weights(tmp_path_factory):
    """The JAX package's seeded llama-tiny weights, this package's tree,
    and the file the gloo ranks read them from."""
    args = train_fsdp.parse_args(FSDP_ARGS)
    params = _shared_params(args.model, args.seed)
    path = str(tmp_path_factory.mktemp("fsdp_weights") / "params.pt")
    torch.save(params, path)
    return params, path


@pytest.fixture(scope="module")
def single_device_fsdp(fsdp_weights):
    return train_fsdp.run(train_fsdp.parse_args(FSDP_ARGS + ["--mesh", "fsdp=1"]), params=fsdp_weights[0])


def test_train_fsdp_losses_match_jax(single_device_fsdp):
    want = _jax_fsdp_losses(train_fsdp.parse_args(FSDP_ARGS))
    assert len(single_device_fsdp) == 3 == len(want)
    np.testing.assert_allclose(single_device_fsdp, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mesh", ["fsdp=4", "fsdp=2,tp=2"])
def test_train_fsdp_on_gloo_ranks_equals_one_device(mesh, single_device_fsdp, fsdp_weights, tmp_path):
    ranks = _fsdp_ranks(tmp_path, mesh, fsdp_weights[1])
    assert all(r == ranks[0] for r in ranks)
    assert len(ranks[0]) == 3
    np.testing.assert_allclose(ranks[0], single_device_fsdp, rtol=0, atol=ATOL)


def _claims(model: str) -> set:
    from thunder_tpu_torch.parallel import build_train_step

    cfg = dataclasses.replace(tgpt.name_to_config(model), n_layer=1)
    params = tgpt.init_params(cfg, dtype=torch.bfloat16, seed=0, device="cpu")
    idx = torch.zeros(1, 64, dtype=torch.int32)
    _, _, extrace = build_train_step(cfg, params, idx, idx, optimizer="sgd", return_extrace=True)
    return {(b.sym.name, b.sym.executor.name) for b in extrace.bound_symbols
            if getattr(b.sym, "executor", None) is not None}


def test_pythia_partial_rotary_is_not_claimed_by_the_rope_kernel():
    pythia = _claims("pythia-160m")
    kernels = {("sdpa_fwd_res", "flash"), ("sdpa_bwd_res", "flash"), ("cross_entropy", "fused"),
               ("cross_entropy_bwd", "fused")}
    assert kernels <= pythia
    assert ("apply_rope", "fused") not in pythia
    cfg = tgpt.name_to_config("pythia-160m")
    assert cfg.rope_n_elem * 4 == cfg.head_size
    assert kernels | {("apply_rope", "fused")} <= _claims("open_llama_3b")

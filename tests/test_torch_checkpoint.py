"""Checkpoints, the supervisor, the data streams and the training CLI of
the port, on the CPU.

Each test of the JAX package's ``tests/test_checkpoint.py`` in the port's
terms, plus what the port's design adds: bf16 leaves stored as their
uint16 bits, a host snapshot taken before an async ``save`` returns (the
step updates the state in place), ``restore`` into the live tensors, a
supervisor run with two injected failures equal bit for bit to an
uninterrupted one, the data streams equal to the JAX package's, and the
CLI. One test shows a fault of the reference's compressed training under
its supervisor (``ROADMAP.md`` C).
"""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import Preemption as JaxPreemption
from repro.checkpointing import Supervisor as JaxSupervisor
from repro.checkpointing import SupervisorConfig as JaxSupervisorConfig
from repro.data import ImageStream as JaxImageStream
from repro.data import TokenStream as JaxTokenStream
from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.train import OptConfig as JOptConfig
from repro.train import make_train_state as jax_train_state
from repro.train import make_train_step as jax_train_step
from repro_torch.checkpointing import (HardwareFailure, Preemption,
                                       Supervisor, SupervisorConfig)
from repro_torch.checkpointing import checkpoint as ckpt
from repro_torch.data import ImageStream, TokenStream
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, get_config
from repro_torch.train import OptConfig, make_train_state, make_train_step

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=30)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread (more only spin against the
    other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_cfg(**extra):
    """``tests/test_checkpoint.py``'s ``_tiny_model``."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab=128, dtype="float32", remat=False)
    kw.update(extra)
    return dataclasses.replace(get_config("qwen2.5-3b"), **kw)


def _state(seed=0, **extra):
    m = build_model(_tiny_cfg(**extra), device="cpu")
    return m, make_train_state(m, torch.Generator().manual_seed(seed))


def _leaves(state):
    return ckpt._flatten_with_paths(state)


def _snapshot(state):
    return [(p, t.detach().clone()) for p, t in _leaves(state)]


def _assert_equal(state, snap):
    got = _leaves(state)
    assert [p for p, _ in got] == [p for p, _ in snap]
    for (p, a), (_, b) in zip(got, snap):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def _perturb(state):
    with torch.no_grad():
        for _, t in _leaves(state):
            t.add_(1)


# ------------------------------------------- tests/test_checkpoint.py's
def test_roundtrip(tmp_path):
    m, state = _state()
    _, s2 = _state(seed=1)
    ckpt.save(str(tmp_path), 7, state, data_state={"seed": 1, "step": 42})
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored, ds, step = ckpt.restore(str(tmp_path), s2)
    assert restored is s2 and step == 7 and ds == {"seed": 1, "step": 42}
    _assert_equal(s2, _snapshot(state))


def test_async_save_and_latest_pointer(tmp_path):
    _, state = _state()
    t = ckpt.save(str(tmp_path), 1, state, asynchronous=True)
    t.join(timeout=60)
    assert not t.is_alive()
    t2 = ckpt.save(str(tmp_path), 2, state, asynchronous=True)
    t2.join(timeout=60)
    assert not t2.is_alive()
    assert ckpt.latest_step(str(tmp_path)) == 2
    _, _, step = ckpt.restore(str(tmp_path), state)
    assert step == 2
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_1", "step_2"]


def test_elastic_shard_fn(tmp_path):
    """restore() hands each leaf (a host tensor in the leaf's dtype) to
    shard_fn before copying it in."""
    _, state = _state()
    ckpt.save(str(tmp_path), 0, state)
    seen = []

    def shard_fn(path, host):
        assert host.device.type == "cpu"
        seen.append(path)
        return host
    ckpt.restore(str(tmp_path), state, shard_fn=shard_fn)
    assert seen == [p for p, _ in _leaves(state)]


def test_supervisor_recovers_from_failures(tmp_path):
    m, state = _state()
    step_fn = make_train_step(m, OptConfig(**OPT))
    data = TokenStream(m.cfg.vocab, batch=4, seq=32)
    fails = {5: Preemption, 11: HardwareFailure}

    def hook(s):
        if s in fails:
            raise fails.pop(s)(f"injected at {s}")

    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=4,
                                      async_save=False),
                     step_fn, state, data, fail_hook=hook)
    out = sup.run(20)
    assert out["steps"] == 20
    assert out["restarts"] == 2
    assert np.isfinite(out["final_loss"])


def test_supervisor_aborts_on_poison_step(tmp_path):
    m, state = _state()
    data = TokenStream(m.cfg.vocab, batch=4, seq=16)

    def hook(s):
        if s == 3:
            raise Preemption("always fails")

    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                                      max_retries=2, async_save=False),
                     make_train_step(m, OptConfig()), state, data,
                     fail_hook=hook)
    with pytest.raises(RuntimeError, match="failed"):
        sup.run(10)
    assert sup.restarts == 2


def test_data_pipeline_deterministic_resume():
    d1 = TokenStream(100, batch=4, seq=16, seed=3)
    b1 = d1.next()
    b2 = d1.next()
    snap = d1.snapshot()
    b3 = d1.next()
    d2 = TokenStream(100, batch=4, seq=16, seed=0)
    d2.restore(snap)
    b3b = d2.next()
    np.testing.assert_array_equal(b3["tokens"], b3b["tokens"])
    assert not np.array_equal(b1["tokens"], b2["tokens"])


def test_rank_sharding_disjoint_streams():
    a = TokenStream(100, batch=8, seq=16, seed=0, n_ranks=2, rank=0)
    b = TokenStream(100, batch=8, seq=16, seed=0, n_ranks=2, rank=1)
    assert a.local_batch == 4
    assert not np.array_equal(a.next()["tokens"], b.next()["tokens"])


# ---------------------------------------------------- the port's design
def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    """A bf16 model: its weights are stored as uint16 bits with dtype
    "bfloat16" in the JSON index and come back bit for bit (NaN and
    subnormal patterns included)."""
    m, state = _state(dtype="bfloat16")
    wq = state["params"]["layers.0.attn.wq"]
    assert wq.dtype == torch.bfloat16
    with torch.no_grad():
        flat = wq.view(-1)
        flat[:4] = torch.tensor([0x7FC1, 0x0001, 0x8000, 0xFF80],
                                dtype=torch.int32).to(torch.int16).view(
                                    torch.bfloat16)
    snap = _snapshot(state)
    ckpt.save(str(tmp_path), 3, state)
    import json
    with open(tmp_path / "step_3" / "index.json") as f:
        index = json.load(f)
    dtypes = dict(zip(index["paths"], index["dtypes"]))
    assert dtypes["params/layers.0.attn.wq"] == "bfloat16"
    assert dtypes["opt/master/layers.0.attn.wq"] == "float32"
    assert dtypes["opt/step"] == "int32"
    _perturb(state)
    ckpt.restore(str(tmp_path), state)
    got = [(p, t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
           for p, t in _leaves(state)]
    exp = [(p, t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
           for p, t in snap]
    for (p, a), (_, b) in zip(got, exp):
        assert torch.equal(a, b), p


def test_async_save_snapshots_before_returning(tmp_path, monkeypatch):
    """The state changes in place right after an async ``save`` returns
    (here while the writer is held at its first file): the checkpoint
    holds the state as it was at the call, bit for bit."""
    _, state = _state()
    snap = _snapshot(state)
    gate = threading.Event()
    savez = np.savez

    def held_savez(*a, **k):
        assert gate.wait(timeout=60)
        return savez(*a, **k)
    monkeypatch.setattr(np, "savez", held_savez)
    t = ckpt.save(str(tmp_path), 5, state, asynchronous=True)
    _perturb(state)
    gate.set()
    t.join(timeout=60)
    assert not t.is_alive()
    ckpt.restore(str(tmp_path), state)
    _assert_equal(state, snap)


def test_async_writer_failure_surfaces_on_join(tmp_path, monkeypatch):
    _, state = _state()

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", broken)
    t = ckpt.save(str(tmp_path), 1, state, asynchronous=True)
    with pytest.raises(OSError, match="disk full"):
        t.join(timeout=60)
    assert ckpt.latest_step(str(tmp_path)) is None


def test_restore_writes_into_live_tensors(tmp_path):
    """The train step closes over the model's parameters and the
    optimizer's tensors: after a restore the same objects hold the
    checkpoint's values, and a step from there equals a step from the
    state that was saved."""
    m, state = _state()
    step = make_train_step(m, OptConfig(**OPT))
    batch = TokenStream(m.cfg.vocab, batch=2, seq=16, seed=4).next()
    step(state, batch)
    ckpt.save(str(tmp_path), 1, state)
    ids = [id(t) for _, t in _leaves(state)]
    _, after = step(state, batch)
    after = {k: v.clone() for k, v in after.items()}
    expect = _snapshot(state)
    step(state, batch)                      # move on, then go back
    ckpt.restore(str(tmp_path), state)
    assert [id(t) for _, t in _leaves(state)] == ids
    assert all(p is state["params"][n] for n, p in m.named_parameters())
    _, again = step(state, batch)
    for k in after:
        assert torch.equal(after[k], again[k]), k
    _assert_equal(state, expect)


def test_restore_refuses_missing_leaf_and_wrong_shape(tmp_path):
    """Checked before any leaf is written: a refused restore leaves the
    live state as it was."""
    m, state = _state()
    ckpt.save(str(tmp_path), 0, state)
    _, wider = _state(d_ff=256)
    snap = _snapshot(wider)
    with pytest.raises(ValueError, match="w_gate"):
        ckpt.restore(str(tmp_path), wider)
    _assert_equal(wider, snap)
    state["opt"]["extra"] = {"x": torch.zeros(3)}
    with pytest.raises(KeyError, match="opt/extra/x"):
        ckpt.restore(str(tmp_path), state)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), state)


def _losses_by_step(log):
    out = {}
    for entry in log:
        out[entry["step"]] = entry["loss"]
    return [out[k] for k in sorted(out)]


@pytest.mark.parametrize("async_save", [False, True])
def test_supervised_run_with_failures_equals_uninterrupted(tmp_path,
                                                           async_save):
    """12 steps, a checkpoint every 4, a Preemption at step 5 and a
    HardwareFailure at step 9: the losses of every step and the final
    state equal an uninterrupted run's bit for bit on the CPU."""
    runs = []
    for i, fails in enumerate(({}, {5: Preemption, 9: HardwareFailure})):
        m, state = _state()
        data = TokenStream(m.cfg.vocab, batch=4, seq=32, seed=1)

        def hook(s, fails=fails):
            if s in fails:
                raise fails.pop(s)(f"injected at {s}")
        sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path / str(i)),
                                          ckpt_every=4,
                                          async_save=async_save),
                         make_train_step(m, OptConfig(**OPT)), state, data,
                         fail_hook=hook)
        out = sup.run(12)
        runs.append((out, _losses_by_step(sup.metrics_log),
                     _snapshot(state), data.snapshot()))
    (o0, l0, s0, d0), (o1, l1, s1, d1) = runs
    assert o0["restarts"] == 0 and o1["restarts"] == 2
    assert o1["steps"] == 12 and d0 == d1 == {"seed": 1, "step": 12}
    assert l0 == l1 and o0["final_loss"] == o1["final_loss"]
    for (p, a), (_, b) in zip(s0, s1):
        assert torch.equal(a, b), p
    assert sorted(os.listdir(tmp_path / "1")) == [
        "LATEST", "step_0", "step_12", "step_4", "step_8"]


def test_supervisor_counts_a_straggler(tmp_path):
    """A step five times slower than the running mean counts once."""
    import time
    m, state = _state()
    step = make_train_step(m, OptConfig(**OPT))

    def slow_step(s, b):
        if slow_step.n == 4:
            time.sleep(max(0.5, 20 * slow_step.dt))
        t0 = time.perf_counter()
        out = step(s, b)
        slow_step.dt = time.perf_counter() - t0
        slow_step.n += 1
        return out
    slow_step.n, slow_step.dt = 0, 0.0
    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                                      straggler_factor=5.0),
                     slow_step, state,
                     TokenStream(m.cfg.vocab, batch=2, seq=16))
    assert sup.run(6)["stragglers"] == 1


def test_compressed_run_restores_its_first_checkpoint(tmp_path):
    """int8 compression under the supervisor with a failure at step 2
    (the only checkpoint is step 0's). The reference's state gains its
    residual at the first step, so restoring the step-0 checkpoint into
    it fails; the port's state holds the residual from the start and
    recovers."""
    cfg = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
               vocab=128, dtype="float32", remat=False)

    def hook(s, fails={2: JaxPreemption}):
        if s in fails:
            raise fails.pop(s)("injected")
    jm = jax_build(dataclasses.replace(jax_config("qwen2.5-3b"), **cfg))
    jopt = JOptConfig(**OPT)
    jsup = JaxSupervisor(
        JaxSupervisorConfig(ckpt_dir=str(tmp_path / "jax"), ckpt_every=4,
                            async_save=False),
        jax.jit(jax_train_step(jm, jopt, compress_grads=True)),
        jax_train_state(jm, jax.random.PRNGKey(0), jopt),
        JaxTokenStream(128, batch=2, seq=16), fail_hook=hook)
    with pytest.raises(KeyError, match="ef_residual"):
        jsup.run(6)

    m = build_model(_tiny_cfg(), device="cpu")
    state = make_train_state(m, torch.Generator().manual_seed(0),
                             compress_grads=True)

    def hook2(s, fails={2: Preemption}):
        if s in fails:
            raise fails.pop(s)("injected")
    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path / "port"),
                                      ckpt_every=4, async_save=False),
                     make_train_step(m, OptConfig(**OPT),
                                     compress_grads=True),
                     state, TokenStream(128, batch=2, seq=16),
                     fail_hook=hook2)
    out = sup.run(6)
    assert out["restarts"] == 1 and out["steps"] == 6


# ------------------------------------------------------- data streams
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_token_stream_equals_the_jax_packages(seed):
    for n_ranks, rank in ((1, 0), (2, 0), (2, 1), (4, 3)):
        a = TokenStream(300, batch=8, seq=24, seed=seed, n_ranks=n_ranks,
                        rank=rank)
        b = JaxTokenStream(300, batch=8, seq=24, seed=seed, n_ranks=n_ranks,
                           rank=rank)
        for _ in range(4):
            x, y = a.next(), b.next()
            assert sorted(x) == sorted(y) == ["labels", "tokens"]
            for k in x:
                assert x[k].dtype == y[k].dtype == np.int32
                np.testing.assert_array_equal(x[k], y[k])
        assert a.snapshot() == b.snapshot()


@pytest.mark.parametrize("seed", [0, 5])
def test_image_stream_equals_the_jax_packages(seed):
    a, b = ImageStream(37, 21, seed=seed), JaxImageStream(37, 21, seed=seed)
    for _ in range(3):
        x, y = a.next(), b.next()
        assert x.dtype == y.dtype == np.float32 and x.shape == (21, 37)
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------- CLI
def _cli(capsys, *args):
    assert train_cli.main(["--arch", "qwen2.5-3b", "--reduced", "--device",
                           "cpu", "--batch", "2", "--seq", "32",
                           *args]) == 0
    return capsys.readouterr().out


def test_train_cli_runs_and_resumes_on_cpu(tmp_path, capsys):
    """4 steps with a checkpoint every 2, then ``--resume`` to step 6:
    the lines the reference's CLI prints."""
    d = str(tmp_path / "ck")
    out = _cli(capsys, "--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2")
    assert "done: {'steps': 4, 'restarts': 0" in out and "on cpu" in out
    loss = [ln for ln in out.splitlines() if ln.startswith("loss: ")]
    assert len(loss) == 1
    first = float(loss[0].split("first=")[1].split()[0])
    assert np.isfinite(first) and abs(first - np.log(1024)) < 1.5
    assert sorted(os.listdir(d)) == ["LATEST", "step_0", "step_2", "step_4"]
    out = _cli(capsys, "--steps", "6", "--ckpt-dir", d, "--ckpt-every", "2",
               "--resume")
    assert "resumed from step 4" in out
    assert "done: {'steps': 6, 'restarts': 0" in out
    assert ckpt.latest_step(d) == 6


def test_train_cli_refuses_distributed(capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "qwen2.5-3b", "--distributed"])
    assert "ROADMAP.md" in capsys.readouterr().err


def test_train_cli_defaults_to_the_card(capsys):
    """Without ``--device`` the CLI asks for the card, which this machine
    may not have: it either runs there or says so."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen2.5-3b", "--reduced", "--steps", "1"])

"""The port's ``distributed/`` against the JAX package's, on the CPU.

The mirrors of ``tests/test_distributed.py``: ``plan_1f1b`` (starts and
stash equal to the reference's), the specs on a host mesh, a train step
under them, ``pipeline_forward`` against the sequential forward and
against the reference's ``shard_map`` run on 4 host devices (in a
subprocess, as the reference's test runs it), and a small dry-run cell.
Then the four spec functions against the reference's for all 10 archs at
full config on the (1, 1), (16, 16) and (2, 16, 16) meshes: the
reference's spec functions read only ``mesh.shape``, so they run here on
a stub mesh over ``jax.eval_shape`` trees; a per-layer port spec is the
reference's with its stack dim removed. Last, the training CLI's
``--distributed`` (a one-rank gloo group here) against the plain run,
bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

from repro.distributed import sharding as jshd
from repro.distributed.pipeline import plan_1f1b as jax_plan_1f1b
from repro.launch import shapes as jshapes
from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro_torch.checkpointing import checkpoint as ckpt
from repro_torch.configs import ALL_ARCHS
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.pipeline import pipeline_forward, plan_1f1b
from repro_torch.launch import dryrun, shapes
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import compat_make_mesh, make_host_mesh, \
    mesh_scope
from repro_torch.models import build_model, get_config
from repro_torch.train import OptConfig, make_train_state, make_train_step

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
META = torch.device("meta")
MESHES = {"card": ((1, 1), ("data", "model")),
          "pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_sub(code: str, devices: int = 8) -> str:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


# ------------------------------------------------------------- 1F1B plan
def test_plan_1f1b_matches_known_bound():
    for n in (2, 4, 8, 16):
        starts, stash = plan_1f1b(n)
        assert stash == {i: 2 * (n - i) - 1 for i in range(n)}
        for i in range(1, n):
            assert starts[f"f{i}"] == starts[f"f{i-1}"] + 1


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_plan_1f1b_equals_the_references(n):
    starts, stash = plan_1f1b(n)
    jstarts, jstash = jax_plan_1f1b(n)
    assert starts == jstarts and stash == jstash


# -------------------------------------------------------- specs, host mesh
def test_param_specs_basic():
    mesh = make_host_mesh(2, 4, device="cpu")
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2,
                              d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
                              vocab=64)
    m = build_model(cfg, device=META)
    specs = shd.param_specs(m, dict(m.named_parameters()), mesh)
    assert sorted(specs) == sorted(n for n, _ in m.named_parameters())
    # embed table: vocab on model, d on data
    assert specs["embed.table"] == ("model", "data")
    # attention wq: heads on model (4 % 4 == 0)
    assert "model" in specs["layers.0.attn.wq"]
    # kv heads 2 % 4 != 0: replicated
    assert specs["layers.0.attn.wk"] == ("data", None, None)
    assert shd.shard_leaf(mesh, specs["embed.table"]).device == \
        torch.device("cpu")


def test_train_step_runs_under_host_mesh_specs():
    """The reference's pjit test on one device: the state's specs on a
    (2, 4) mesh cover every leaf, and two steps train."""
    mesh = make_host_mesh(2, 4, device="cpu")
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2,
                              d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                              vocab=128, dtype="float32", remat=False)
    m = build_model(cfg, device="cpu")
    opt = OptConfig(lr=1e-3)
    state = make_train_state(m, torch.Generator().manual_seed(0))
    sspec = shd.state_specs(m, state, mesh)
    for key in ("master", "m", "v"):
        assert sspec["opt"][key] == sspec["params"]
    assert sspec["opt"]["step"] == ()
    assert sorted(sspec["params"]) == sorted(state["params"])
    batch = {"tokens": np.ones((8, 32), np.int32),
             "labels": np.ones((8, 32), np.int32)}
    bspec = shd.batch_specs({k: torch.as_tensor(v) for k, v in
                             batch.items()}, mesh)
    assert bspec == {"tokens": ("data", None), "labels": ("data", None)}
    step = make_train_step(m, opt)
    with mesh_scope(mesh):
        _, m1 = step(state, batch)
        _, m2 = step(state, batch)
    assert np.isfinite(float(m2["loss"]))
    assert float(m2["loss"]) < float(m1["loss"]) + 1.0


def test_dryrun_single_cell_small():
    """A small gemma3 cell on a (2, 4) mesh: specs, batch specs and a
    counted train step's FLOPs (``FlopCounterMode`` over the loss and
    its backward on meta)."""
    from torch.utils.flop_counter import FlopCounterMode
    mesh = compat_make_mesh((2, 4), ("data", "model"), device="cpu")
    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=6,
                              d_model=64, n_heads=4, n_kv_heads=1,
                              head_dim=16, d_ff=128, vocab=256, window=8)
    m = build_model(cfg, device=META)
    state = dryrun.abstract_state(m)
    sspec = shd.state_specs(m, state, mesh)
    batch = shapes.train_input_specs(cfg, 8, 64)
    bspec = shd.batch_specs(batch, mesh)
    card = compat_make_mesh((1, 1), ("data", "model"), device="cpu")
    assert dryrun.tree_bytes(state, sspec, mesh) < dryrun.tree_bytes(
        state, shd.state_specs(m, state, card), card)
    assert bspec["tokens"] == ("data", None)
    m.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        loss, _ = m.loss({"tokens": batch["tokens"],
                          "labels": batch["labels"]})
        loss.backward()
    assert fc.get_total_flops() > 0


# ------------------------------------------------------- pipeline forward
def _pipeline_inputs():
    rng = np.random.RandomState(0)
    n_stages, n_micro, mb, d = 4, 6, 2, 8
    w = (rng.standard_normal((n_stages, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    return w, x


def test_pipeline_forward_equals_sequential_and_the_reference(tmp_path):
    w, x = _pipeline_inputs()
    np.save(tmp_path / "w.npy", w)
    np.save(tmp_path / "x.npy", x)
    run_sub(f"""
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import pipeline_forward
    from repro.launch.mesh import compat_make_mesh
    mesh = compat_make_mesh((4,), ("stage",))
    w = jnp.asarray(np.load({str(tmp_path / 'w.npy')!r}))
    x = jnp.asarray(np.load({str(tmp_path / 'x.npy')!r}))
    out = pipeline_forward(w, x, lambda wi, h: jnp.tanh(h @ wi), mesh)
    np.save({str(tmp_path / 'out.npy')!r}, np.asarray(out))
    """, devices=4)
    ref = np.load(tmp_path / "out.npy")
    mesh = compat_make_mesh((4,), ("stage",), device="cpu")
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    out = pipeline_forward(tw, tx, lambda wi, h: torch.tanh(h @ wi), mesh)
    seq = tx
    for i in range(4):
        seq = torch.tanh(seq @ tw[i])
    assert out.shape == tx.shape
    assert float((out - seq).abs().max()) < 1e-5
    assert float(np.abs(out.numpy() - ref).max()) < 1e-5


@pytest.mark.parametrize("n_stages,n_micro", [(1, 3), (2, 1), (3, 5),
                                              (5, 2)])
def test_pipeline_forward_any_depth_and_stage_sequence(n_stages, n_micro):
    """Stages given as a sequence (the port's super-blocks are modules of
    their own) or as a dict of stacked tensors."""
    rng = np.random.RandomState(n_stages * 10 + n_micro)
    w = torch.from_numpy(rng.standard_normal((n_stages, 6, 6))
                         .astype(np.float32) * 0.3)
    b = torch.from_numpy(rng.standard_normal((n_stages, 6))
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n_micro, 3, 6))
                         .astype(np.float32))
    mesh = compat_make_mesh((n_stages,), ("stage",), device="cpu")
    seq = x
    for i in range(n_stages):
        seq = torch.tanh(seq @ w[i] + b[i])
    got = pipeline_forward({"w": w, "b": b}, x,
                           lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                           mesh)
    assert float((got - seq).abs().max()) < 1e-5
    stages = [(w[i], b[i]) for i in range(n_stages)]
    got = pipeline_forward(stages, x,
                           lambda p, h: torch.tanh(h @ p[0] + p[1]), mesh)
    assert float((got - seq).abs().max()) < 1e-5
    with pytest.raises(ValueError):
        pipeline_forward(stages[:-1] + stages[:1] * 2, x,
                         lambda p, h: h, mesh)


# ------------------------------------------- the four spec functions, full
@pytest.fixture(scope="module")
def reference_trees():
    """arch -> (JAX model, params eval_shape) at full config."""
    out = {}

    def get(arch):
        if arch not in out:
            jm = jax_build(jax_config(arch))
            out[arch] = jm, jax.eval_shape(lambda k: jm.init(k),
                                           jax.random.PRNGKey(0))
        return out[arch]
    return get


def _ref_named(model, tree):
    """(port name, reference leaf) for a parameter-shaped reference tree:
    the super-block leaves keyed by the port's layer names."""
    def block(prefix, sub):
        for k, v in sub.items():
            if isinstance(v, dict):
                yield from block(f"{prefix}.{k}", v)
            else:
                yield f"{prefix}.{k}", v
    yield "embed.table", tree["embed"]["table"], False
    for n, (si, ki, _, _) in enumerate(model._stack()):
        for name, leaf in block(f"layers.{n}", tree["segments"][si][ki]):
            yield name, leaf, True
    yield "final_ln.scale", tree["final_ln"]["scale"], False
    if model.lm_head is not None:
        yield "lm_head", tree["lm_head"], False


def _stripped(spec, stacked):
    spec = tuple(spec)
    if stacked:
        assert spec[0] is None
        return spec[1:]
    return spec


def _cache_equal(got, exp):
    assert len(got) == len(exp)
    for gseg, eseg in zip(got, exp):
        assert len(gseg) == len(eseg)
        for g, e in zip(gseg, eseg):
            assert sorted(g) == sorted(e)
            for k in g:
                assert tuple(g[k]) == tuple(e[k]), k


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_equal_the_references(arch, mesh_name, reference_trees):
    shape, axes = MESHES[mesh_name]
    mesh = compat_make_mesh(shape, axes, device="cpu")
    stub = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    jm, jtree = reference_trees(arch)
    cfg = get_config(arch)
    model = build_model(cfg, device=META)
    params = dict(model.named_parameters())

    # parameters and the train state
    jp = jshd.param_specs(jm, jtree, stub)
    tp = shd.param_specs(model, params, mesh)
    pairs = {n: _stripped(s, st) for n, s, st in _ref_named(model, jp)}
    assert sorted(pairs) == sorted(tp)
    for n in tp:
        assert tuple(tp[n]) == pairs[n], n
    js = jshd.state_specs(jm, {"params": jtree}, stub)
    ts = shd.state_specs(model, dryrun.abstract_state(model), mesh)
    assert tuple(ts["opt"]["step"]) == tuple(js["opt"]["step"]) == ()
    for key in ("master", "m", "v"):
        exp = {n: _stripped(s, st)
               for n, s, st in _ref_named(model, js["opt"][key])}
        assert {n: tuple(s) for n, s in ts["opt"][key].items()} == exp
    assert ts["params"] == tp

    # batches of every shape, and the decode caches
    for name, sh in shapes.SHAPES.items():
        b, s = sh["batch"], sh["seq"]
        tb = shapes.train_input_specs(cfg, b, s)
        jb = jshapes.train_input_specs(jax_config(arch), b, s)
        got = shd.batch_specs(tb, mesh)
        exp = jshd.batch_specs(jb, stub)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in exp.items()}, name
        if shapes.cell_status(arch, name) != "run" or \
                sh["kind"] != "decode":
            continue
        tspec = shapes.decode_input_specs(model, b, s)
        jspec = jshapes.decode_input_specs(jm, b, s)
        _cache_equal(shd.cache_specs(model, tspec["caches"], mesh),
                     jshd.cache_specs(jm, jspec["caches"], stub))
        io = {"tokens": tspec["tokens"], "pos": tspec["pos"]}
        jio = {"tokens": jspec["tokens"], "pos": jspec["pos"]}
        assert {k: tuple(v) for k, v in shd.batch_specs(io, mesh).items()} \
            == {k: tuple(v) for k, v in jshd.batch_specs(jio, stub).items()}


def test_every_spec_is_replicated_on_the_card_mesh():
    mesh = compat_make_mesh((1, 1), ("data", "model"), device="cpu")
    for arch in ("gemma3-1b", "mixtral-8x22b", "rwkv6-1.6b"):
        model = build_model(get_config(arch), device=META)
        params = dict(model.named_parameters())
        for n, s in shd.param_specs(model, params, mesh).items():
            assert shd.per_device_bytes(params[n], s, mesh) == \
                params[n].numel() * params[n].element_size()


# ------------------------------------------------------- --distributed CLI
def _cli(capsys, tmp, *args):
    assert train_cli.main(["--arch", "qwen2.5-3b", "--reduced", "--device",
                           "cpu", "--batch", "2", "--seq", "32", "--steps",
                           "3", "--ckpt-every", "3", "--ckpt-dir", tmp,
                           *args]) == 0
    return capsys.readouterr().out


def _state(tmp, template):
    state, _, step = ckpt.restore(tmp, template)
    assert step == 3
    return {k: v.clone() for k, v in
            ckpt._flatten_with_paths(state)}


def test_distributed_cli_equals_the_plain_run_bit_for_bit(tmp_path, capsys):
    import torch.distributed as dist
    plain = _cli(capsys, str(tmp_path / "a"))
    group = _cli(capsys, str(tmp_path / "b"), "--distributed")
    assert "in a process group (gloo, world size 1)" in group
    assert not dist.is_initialized()            # destroyed at exit
    for key in ("loss: ", "losses: "):
        lines = [ln for ln in plain.splitlines() if ln.startswith(key)]
        assert len(lines) == 1
        assert lines == [ln for ln in group.splitlines()
                         if ln.startswith(key)]
    cfg = train_cli.reduced_config(get_config("qwen2.5-3b"))
    model = build_model(cfg, device="cpu")
    template = make_train_state(model, torch.Generator().manual_seed(9))
    a = _state(str(tmp_path / "a"), template)
    b = _state(str(tmp_path / "b"), template)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_distributed_cli_refuses_more_than_one_rank(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="single card"):
        train_cli.main(["--arch", "qwen2.5-3b", "--reduced", "--device",
                        "cpu", "--distributed"])


def test_distributed_cli_meets_through_env_variables(tmp_path, capsys,
                                                     monkeypatch):
    """torchrun's ``env://`` variables, where set, are the rendezvous."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    out = _cli(capsys, str(tmp_path / "c"), "--distributed")
    assert "in a process group (gloo, world size 1)" in out

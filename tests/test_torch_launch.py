"""The port's launch helpers and dry run against the JAX package's.

``repro_torch.launch.shapes`` against ``repro.launch.shapes`` (the cells,
every input spec's keys, shapes and dtypes, the caches at full config),
``repro_torch.launch.mesh`` (one-card meshes with the reference's API,
the H100 record), and ``repro_torch.launch.dryrun``: the mirrors of
``tests/test_dryrun_utils.py`` (the HLO collective parser has no
counterpart: eager PyTorch has no HLO), the whole 40-cell dry run on the
CPU, every runnable cell's ``arg_bytes`` against an independent sum over
the port's meta state, and the leaves whose stored dtype differs from
the reference's ``_cast_params``. Everything is counted on the meta
device; no test allocates a full-size model.
"""
import dataclasses
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import shapes as jshapes
from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro_torch.configs import ALL_ARCHS
from repro_torch.launch import dryrun, mesh as tmesh, shapes
from repro_torch.models import build_model, get_config
from repro_torch.perf.measure import datasheet_peaks

ROOT = os.path.join(os.path.dirname(__file__), "..")
META = torch.device("meta")
JDTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.float32): torch.float32}
RUNNABLE = [(a, s) for a in ALL_ARCHS for s in shapes.SHAPES
            if shapes.cell_status(a, s) == "run"]


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without keeping the 512-device
    XLA flag it sets for later subprocesses of this worker."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdry
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jdry


# ------------------------------------------------------------ shapes
def test_cell_status_skips():
    cs = shapes.cell_status
    assert cs("hubert-xlarge", "decode_32k").startswith("SKIP")
    assert cs("hubert-xlarge", "long_500k").startswith("SKIP")
    assert cs("qwen2.5-3b", "long_500k").startswith("SKIP")
    assert cs("rwkv6-1.6b", "long_500k") == "run"
    assert cs("gemma3-1b", "long_500k") == "run"
    assert cs("mixtral-8x22b", "train_4k") == "run"
    runnable = sum(1 for a in ALL_ARCHS for s in shapes.SHAPES
                   if cs(a, s) == "run")
    assert runnable == len(RUNNABLE) == 33


def test_cells_equal_the_reference():
    from repro.configs import ALL_ARCHS as JARCHS
    assert sorted(JARCHS) == sorted(ALL_ARCHS)
    assert shapes.SHAPES == jshapes.SHAPES
    assert shapes.SUBQUADRATIC == jshapes.SUBQUADRATIC
    for a in ALL_ARCHS:
        for s in shapes.SHAPES:
            assert shapes.cell_status(a, s) == jshapes.cell_status(a, s)


def _same_spec(got: torch.Tensor, exp, where: str):
    assert got.device == META, where
    assert tuple(got.shape) == tuple(exp.shape), where
    assert got.dtype == JDTYPES[jnp.dtype(exp.dtype)], where


def _walk_caches(got, exp, where):
    assert len(got) == len(exp), where
    for si, (gseg, eseg) in enumerate(zip(got, exp)):
        assert len(gseg) == len(eseg), where
        for ki, (g, e) in enumerate(zip(gseg, eseg)):
            assert sorted(g) == sorted(e), where
            for k in g:
                _same_spec(g[k], e[k], f"{where} caches[{si}][{ki}].{k}")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_equal_the_references(arch):
    """Every spec of every shape: keys, shapes and dtypes; the decode
    caches at full config on meta (the reference's ``eval_shape``)."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    model = build_model(cfg, device=META)
    jmodel = jax_build(jcfg)
    for name, sh in shapes.SHAPES.items():
        b, s = sh["batch"], sh["seq"]
        for fn in ("train_input_specs", "prefill_input_specs"):
            got = getattr(shapes, fn)(cfg, b, s)
            exp = getattr(jshapes, fn)(jcfg, b, s)
            assert sorted(got) == sorted(exp), (fn, name)
            for k in got:
                _same_spec(got[k], exp[k], f"{fn} {name} {k}")
        if shapes.cell_status(arch, name) != "run" or sh["kind"] != "decode":
            continue
        got = shapes.decode_input_specs(model, b, s)
        exp = jshapes.decode_input_specs(jmodel, b, s)
        assert sorted(got) == sorted(exp)
        for k in ("tokens", "pos"):
            _same_spec(got[k], exp[k], f"decode {name} {k}")
        _walk_caches(got["caches"], exp["caches"], f"decode {name}")


def test_decode_specs_are_on_meta_whatever_the_models_device():
    cfg = get_config("gemma3-1b")
    small = dataclasses.replace(cfg, n_layers=2, d_model=32, n_heads=2,
                                n_kv_heads=1, head_dim=16, d_ff=64,
                                vocab=64, window=4)
    model = build_model(small, device="cpu")
    got = shapes.decode_input_specs(model, 3, 8)
    leaves = [t for seg in got["caches"] for sub in seg
              for t in sub.values()]
    assert leaves and all(t.device == META for t in leaves)
    assert model.decode_init(3, 8)[0][0]["k"].device.type == "cpu"


# -------------------------------------------------------------- mesh
def test_meshes_keep_the_references_layouts():
    m = tmesh.make_production_mesh(device="cpu")
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    m2 = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    assert m2.axis_names == ("pod", "data", "model")
    h = tmesh.make_host_mesh(device="cpu")
    assert h.shape == {"data": 2, "model": 4}
    c = tmesh.make_card_mesh("cpu")
    assert c.shape == {"data": 1, "model": 1} and c.size == 1
    assert c.device == torch.device("cpu")
    s = tmesh.compat_make_mesh((4,), ("stage",), device="cpu")
    assert s.shape == {"stage": 4}
    with pytest.raises(ValueError):
        tmesh.compat_make_mesh((2, 2), ("data",), device="cpu")


def test_mesh_scope_nests_and_restores():
    a = tmesh.make_card_mesh("cpu")
    b = tmesh.make_host_mesh(device="cpu")
    assert tmesh.current_mesh() is None
    with tmesh.mesh_scope(a):
        assert tmesh.current_mesh() is a
        with tmesh.mesh_scope(b):
            assert tmesh.current_mesh() is b
        assert tmesh.current_mesh() is a
    assert tmesh.current_mesh() is None


def test_card_mesh_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_card_mesh()


def test_h100_record_has_one_home_per_number():
    h = tmesh.H100
    assert h["peak_flops_bf16"] == tmesh.H100_BF16_DENSE_FLOPS == 989e12
    assert h["hbm_bw"] == datasheet_peaks(
        "NVIDIA H100 80GB HBM3").hbm_bytes_per_s
    assert h["hbm_bytes"] == 80e9 and h["nvlink_bw"] == 900e9
    assert tmesh.TPU_V5E == _reference_dryrun().TPU_V5E


# ------------------------------------------------------------ dry run
def test_roofline_terms_dominance():
    d = dryrun
    r = d.roofline_terms(989e12, 0.0, {})          # 1s of pure compute
    assert r["dominant"] == "compute"
    assert r["compute_s"] == pytest.approx(1.0)
    r = d.roofline_terms(0.0, tmesh.H100["hbm_bw"], {})   # 1s of HBM
    assert r["dominant"] == "memory"
    assert r["memory_s"] == pytest.approx(1.0)
    r = d.roofline_terms(0.0, 0.0, {"all-reduce": 900e9})
    assert r["dominant"] == "collective"
    assert r["collective_s"] == pytest.approx(1.0)
    r = d.roofline_terms(0.0, 0.0, {"all-reduce": 100e9}, links_per_chip=2)
    assert r["collective_s"] == pytest.approx(1.0)


def test_model_flops_sane():
    f = dryrun.model_flops("qwen2.5-3b", "train_4k")
    # ~3B params x 6 x 1M tokens ~ 1.9e16 (non-embedding slightly less)
    assert 0.5e16 < f < 5e16
    f_dec = dryrun.model_flops("qwen2.5-3b", "decode_32k")
    assert f_dec < f / 1000


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-3b",
                                  "granite-moe-1b-a400m", "mixtral-8x22b"])
def test_counts_apply_the_stated_rule_where_the_reference_misses(arch):
    """The reference's ``counts`` matches ``"embed/table"`` and
    ``"moe/w_"`` against paths that print as ``['embed']/['table']``:
    it counts the table and every expert in full. The port's count is
    the reference's minus the table, with the experts scaled by
    top_k / n_experts."""
    sys.path.insert(0, ROOT)
    from benchmarks.roofline import counts as jcounts
    jcfg, jn, jk = jcounts(arch)
    jm = jax_build(jcfg)
    tree = jax.eval_shape(lambda k: jm.init(k), jax.random.PRNGKey(0))
    total = sum(math.prod(l.shape) for l in jax.tree.leaves(tree))
    table = math.prod(tree["embed"]["table"].shape)
    experts = sum(math.prod(l.shape) for seg in tree["segments"]
                  for sub in seg if "moe" in sub
                  for k, l in sub["moe"].items() if k.startswith("w_"))
    final_ln = jcfg.d_model
    assert jn == total - final_ln                 # the reference's count
    cfg, n, k = dryrun.counts(arch)
    frac = cfg.top_k / cfg.n_experts if cfg.n_experts else 0
    assert k == jk
    assert n == pytest.approx(jn - table - experts * (1 - frac), rel=1e-12)


@pytest.mark.parametrize("s,w", [(1, 0), (7, 0), (64, 16), (100, 7),
                                 (16, 64), (33, 33)])
def test_attention_keys_closed_form_equals_the_loop(s, w):
    """The closed form against the per-query sum the training phase of
    ``chip_smoke.py`` used: min(t + 1, window) keys for query t."""
    loop = sum(min(t + 1, w or s) for t in range(s))
    assert dryrun._keys(s, w, True) == loop
    assert dryrun._keys(s, w, False) == s * s


def test_attention_flops_count_only_attention_layers():
    g = get_config("gemma3-1b")
    b, s = 2, 64
    per = 4 * g.n_heads * g.hd
    exp = sum(per * sum(min(t + 1, g.window if k == "L" else s)
                        for t in range(s)) for k in g.layer_kinds())
    assert dryrun.attention_flops(g, b, s) == 3.0 * b * exp
    assert dryrun.attention_flops(g, b, s, passes=1.0) == b * exp
    assert dryrun.attention_flops(get_config("rwkv6-1.6b"), b, s) == 0
    r = get_config("recurrentgemma-2b")
    n_attn = sum(k == "attn" for k in r.block_kinds())
    assert dryrun.attention_flops(r, 1, 8, 1.0) == \
        n_attn * 4 * r.n_heads * r.hd * sum(min(t + 1, r.window)
                                            for t in range(8))


@pytest.fixture(scope="module")
def card_cells(tmp_path_factory):
    """The whole dry run on the card's mesh, named on the CPU."""
    out = tmp_path_factory.mktemp("dry") / "cells.json"
    assert dryrun.main(["--all", "--device", "cpu", "--out",
                        str(out)]) == 0
    with open(out) as f:
        return {(c["arch"], c["shape"]): c for c in json.load(f)}


def test_dryrun_counts_all_forty_cells_on_the_cpu(card_cells, capsys):
    cells = card_cells
    assert len(cells) == 40
    run = [c for c in cells.values() if c["status"] == "run"]
    skip = [c for c in cells.values() if c["status"].startswith("SKIP")]
    assert len(run) == 33 and len(skip) == 7
    for c in run:
        assert c["mesh"] == "card" and c["temp_bytes"] is None
        assert c["coll_bytes"] == {} and c["flops_per_dev"] > 0
        assert c["bytes_per_dev"] >= c["arg_bytes"] + c["out_bytes"]
        assert c["fits"] == (c["arg_bytes"] + c["out_bytes"] <= 80e9)
        assert c["roofline"]["collective_s"] == 0
    # mixtral-8x22b does not fit: ~141 B parameters, 2 bytes or more each
    for s in shapes.SHAPES:
        assert cells[("mixtral-8x22b", s)]["fits"] is False
    assert cells[("gemma3-1b", "decode_32k")]["fits"] is True
    assert cells[("qwen2.5-3b", "decode_32k")]["fits"] is False
    # nothing was shrunk: the cells are the reference's shapes
    assert shapes.SHAPES == jshapes.SHAPES


def test_dryrun_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k"])


def _nbytes(t):
    return t.numel() * t.element_size()


@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_arg_bytes_equal_an_independent_sum(arch, shape, card_cells):
    """The port's meta state summed leaf by leaf, as stored: parameters
    (the ``FLOAT32_LEAVES`` in float32), and for train 3 float32 copies
    (master, m, v) of every parameter, a 4-byte step and the batch; for
    decode the caches and two int32 vectors."""
    cfg = get_config(arch)
    model = build_model(cfg, device=META)
    sh = shapes.SHAPES[shape]
    b, s = sh["batch"], sh["seq"]
    params = list(model.parameters())
    p_bytes = sum(_nbytes(p) for p in params)
    n = sum(p.numel() for p in params)
    if sh["kind"] == "train":
        exp = p_bytes + 12 * n + 4 + 2 * b * s * 4
        if cfg.family == "encoder":
            exp += b * s * cfg.d_model * 2
        if cfg.family == "vlm":
            exp += b * cfg.n_vision_tokens * cfg.d_model * 2 + 3 * b * s * 4
    elif sh["kind"] == "prefill":
        exp = p_bytes + b * s * 4
        if cfg.family == "encoder":
            exp += b * s * cfg.d_model * 2
        if cfg.family == "vlm":
            exp += b * cfg.n_vision_tokens * cfg.d_model * 2 + 3 * b * s * 4
    else:
        caches = model.decode_init(b, s, device=META)
        exp = p_bytes + 2 * b * 4 + sum(
            _nbytes(t) for seg in caches for sub in seg
            for t in sub.values())
    got = card_cells[(arch, shape)]
    assert got["arg_bytes"] == exp
    out = 12 if sh["kind"] == "train" else b * cfg.vocab * 4
    assert got["out_bytes"] == out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_stored_dtypes_differ_from_the_references_cast_where_listed(arch):
    """Against the reference's ``_cast_params`` over its full-config
    ``eval_shape`` (per-layer leaves stacked): the leaves whose dtype
    differs are exactly those ``FLOAT32_LEAVES`` names, float32 in the
    port where the reference casts to bf16."""
    jdry = _reference_dryrun()
    jm = jax_build(jax_config(arch))
    cast = jax.eval_shape(lambda k: jdry._cast_params(jm, jm.init(k)),
                          jax.random.PRNGKey(0))
    model = build_model(get_config(arch), device=META)
    params = dict(model.named_parameters())
    ref_dtype = {}

    def dtypes(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from dtypes(v, f"{prefix}.{k}")
            else:
                yield f"{prefix}.{k}", v.dtype
    ref_dtype["embed.table"] = cast["embed"]["table"].dtype
    ref_dtype["final_ln.scale"] = cast["final_ln"]["scale"].dtype
    if "lm_head" in cast:
        ref_dtype["lm_head"] = cast["lm_head"].dtype
    for n, (si, ki, _, _) in enumerate(model._stack()):
        for name, dt in dtypes(cast["segments"][si][ki], f"layers.{n}"):
            ref_dtype[name] = dt
    assert sorted(ref_dtype) == sorted(params)
    differ = {n for n, p in params.items()
              if p.dtype != JDTYPES[jnp.dtype(ref_dtype[n])]}
    listed = {n for n in params if n.endswith(dryrun.FLOAT32_LEAVES)}
    assert differ == listed
    for n in differ:
        assert params[n].dtype == torch.float32
        assert jnp.dtype(ref_dtype[n]) == jnp.dtype(jnp.bfloat16)


def test_logical_axes_cover_every_parameter():
    for arch in ALL_ARCHS:
        model = build_model(get_config(arch), device=META)
        ax = model.logical_axes()
        params = dict(model.named_parameters())
        assert sorted(ax) == sorted(params)
        for n, p in params.items():
            assert len(ax[n]) == p.ndim, n


def test_dryrun_on_the_logical_pod_meshes_divides_each_leaf():
    """On (16, 16) and (2, 16, 16) the per-device bytes are each leaf's
    bytes over the mesh axes its spec names: below the card's, and a
    train cell's flops split over every device."""
    card = dryrun.lower_cell("gemma3-1b", "train_4k",
                             tmesh.make_card_mesh("cpu"), "card", False)
    for name, multi in (("pod", False), ("multipod", True)):
        m = tmesh.make_production_mesh(multi_pod=multi, device="cpu")
        r = dryrun.lower_cell("gemma3-1b", "train_4k", m, name, False)
        assert r.status == "run" and r.arg_bytes < card.arg_bytes
        assert r.flops_per_dev == pytest.approx(card.flops_per_dev / m.size)
        d = dryrun.lower_cell("gemma3-1b", "decode_32k", m, name, False)
        assert 0 < d.arg_bytes and d.fits
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--mesh", "both",
                        "--device", "cpu"]) == 0


def _tool(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_matrix_twin_reruns_only_the_missing_cell(tmp_path, monkeypatch,
                                                      card_cells):
    """``tools/run_matrix_torch.py --only-failures``: the 39 cells of an
    earlier result are kept, the missing one runs in its own
    ``python -m repro_torch.launch.dryrun`` process and lands equal."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "results" / "dryrun_torch.json"
    out.parent.mkdir()
    gone = ("gemma3-1b", "decode_32k")
    with open(out, "w") as f:
        json.dump([c for k, c in card_cells.items() if k != gone], f)
    rm = _tool("run_matrix_torch")
    assert rm.main(["--device", "cpu", "--only-failures", "--out",
                    str(out)]) == 0
    with open(out) as f:
        got = {(c["arch"], c["shape"]): c for c in json.load(f)}
    assert sorted(got) == sorted(card_cells)
    assert os.path.exists(tmp_path / rm.CELLS /
                          "gemma3-1b_decode_32k_card.json")
    for key in ("arg_bytes", "out_bytes", "fits", "flops_per_dev",
                "bytes_per_dev"):
        assert got[gone][key] == card_cells[gone][key], key

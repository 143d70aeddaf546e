"""The port's dry run and its tooling (``repro_torch.train.train_step
.input_specs``, ``distributed.{sharding, hlo_analysis}``, ``launch.{mesh,
dryrun}``, ``env``) against the reference's, on the CPU.

* ``input_specs`` and the sharding rules: every leaf's key path, shape,
  dtype, spec and placements equal to the reference's, for all 10 archs at
  full size (``resolve_for_mesh(tp=16)``; shapes only, no storage);
* collectives: DTensor's on a fake 2 x 2 mesh give the bytes and wire
  bytes of the reference's parser test (``test_hlo_collective_parser``);
* the probe plans field by field, and the affine solve exact;
* ``run_cell`` over a fake 2 x 2 mesh on ``reduced_config`` sizes (the
  production mesh, configs and shapes patched): the reference's keys,
  argument bytes equal to the sum of the local shards the rules give,
  flops of the full trace equal to the probes' extrapolation (rel 1e-9);
* the fake process group closed after each mesh, and ``forward`` with
  placements bit-equal to ``forward`` without them on a one-rank gloo group.
"""
import ast
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_lazy import lazy, require_torch

require_torch()

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.quant.binary_linear import quantize_params as jquant  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
torch = lazy("torch")
dist = lazy("torch.distributed")
tconf = lazy("repro_torch.configs")
tt = lazy("repro_torch.models.transformer")
tts = lazy("repro_torch.train.train_step")
tsh = lazy("repro_torch.distributed.sharding")
thlo = lazy("repro_torch.distributed.hlo_analysis")
tmesh = lazy("repro_torch.launch.mesh")
tdry = lazy("repro_torch.launch.dryrun")
tenv = lazy("repro_torch.env")
tck = lazy("repro_torch.checkpoint.checkpointer")
tquant = lazy("repro_torch.quant.binary_linear")

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]


def _jkey(path) -> str:
    """A jax key path as the checkpoint key string the port writes."""
    out = []
    for e in path:
        if hasattr(e, "key"):
            out.append(str(e.key))
        elif hasattr(e, "idx"):
            out.append(str(e.idx))
        else:
            out.append(f".{e.name}")
    return "/".join(out)


def _jleaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_jkey(p), leaf) for p, leaf in flat]


def _tleaves(tree):
    keys, leaves, _ = tck._flatten(tree)
    return list(zip(keys, leaves))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _full(arch):
    return (get_config(arch).resolve_for_mesh(tp=16),
            tconf.get_config(arch).resolve_for_mesh(tp=16))


def _jmesh(multi):
    if multi:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


@contextlib.contextmanager
def _fake_mesh(shape=(2, 2), axes=("data", "model")):
    """A fake process group of prod(shape) ranks and its mesh, closed on
    exit (the production mesh's helpers at a small shape)."""
    with tmesh._world(math.prod(shape), "fake"):
        yield tmesh._mesh(tmesh._card_type(), shape, axes)


def test_input_specs_match_reference():
    """Every (arch x shape): the same leaves, key paths, shapes, dtypes."""
    for arch in sorted(ARCHS):
        cfg, tcfg = _full(arch)
        for name in SHAPES:
            want = _jleaves(jts.input_specs(cfg, SHAPES[name]))
            got = _tleaves(tts.input_specs(tcfg, tconf.SHAPES[name]))
            assert [(k, tuple(v.shape), _dtype(v)) for k, v in got] == \
                [(k, tuple(v.shape), _dtype(v)) for k, v in want], \
                (arch, name)
            assert all(v.device.type == "meta" for _, v in got)


@pytest.mark.parametrize("quant", [False, True])
def test_param_pspec_matches_reference(quant):
    """``param_pspec`` entry by entry, every leaf of the 10 full configs,
    fsdp on and off, fp and bit-packed (the transpose rule)."""
    n = 0
    for arch in sorted(ARCHS):
        cfg, tcfg = _full(arch)
        jp = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0),
                                                   cfg))
        tp = tt.init_params(tcfg, torch.Generator(), "meta")
        if quant:
            jp = jax.eval_shape(jquant, jp)
            tp = tquant.quantize_params(tp)
        jl, tl = jax.tree_util.tree_flatten_with_path(jp)[0], _tleaves(tp)
        assert [_jkey(p) for p, _ in jl] == [k for k, _ in tl], arch
        for (path, jleaf), (key, tleaf) in zip(jl, tl):
            assert tuple(tleaf.shape) == tuple(jleaf.shape), key
            for fsdp in (False, True):
                want = tuple(jsh.param_pspec(path, jleaf, fsdp))
                assert tsh.param_pspec(key, tleaf, fsdp) == want, \
                    (arch, key, fsdp)
                n += 1
    assert n > 1000


def test_placements_match_reference():
    """``param_placements``, ``data_shardings``, ``cache_shardings``
    (decode_32k and long_500k, with its sequence-parallel branch) and
    ``logits_sharding`` on the (16, 16) and (2, 16, 16) meshes: the
    reference's specs, each as placements of the mesh."""
    for multi in (False, True):
        jm = _jmesh(multi)
        with tmesh.make_production_mesh(multi_pod=multi) as mesh:
            assert mesh.mesh_dim_names == tuple(jm.axis_names)
            assert tuple(mesh.shape) == tuple(jm.axis_sizes)

            def same(got, want_tree, what):
                want = [(k, tsh.placements(tuple(s.spec), mesh))
                        for k, s in _jleaves(want_tree)]
                assert _placement_leaves(got) == want, what

            for arch in ("smollm-135m", "llava-next-34b",
                         "seamless-m4t-medium", "qwen2-moe-a2.7b"):
                cfg, tcfg = _full(arch)
                jp = jax.eval_shape(
                    lambda: jt.init_params(jax.random.PRNGKey(0), cfg))
                tp = tt.init_params(tcfg, torch.Generator(), "meta")
                same(tsh.param_placements(tp, mesh, fsdp=True),
                     jsh.param_shardings(jp, jm, fsdp=True), arch)
                for name in ("train_4k", "prefill_32k"):
                    same(tsh.data_shardings(
                        tts.input_specs(tcfg, tconf.SHAPES[name]), mesh),
                        jsh.data_shardings(jts.input_specs(cfg, SHAPES[name]),
                                           jm), (arch, name))
            for arch in sorted(ARCHS):
                cfg, tcfg = _full(arch)
                for name in ("decode_32k", "long_500k"):
                    jc = jts.input_specs(cfg, SHAPES[name])["cache"]
                    tc_ = tts.input_specs(tcfg, tconf.SHAPES[name])["cache"]
                    same(tsh.cache_shardings(tc_, mesh),
                         jsh.cache_shardings(jc, jm), (arch, name))
            for b in (0, 1, 32, 128, 256, 512):
                assert tsh.logits_sharding(mesh, b) == tsh.placements(
                    tuple(jsh.logits_sharding(jm, b).spec), mesh), b
            assert tsh.replicated(mesh) == tsh.placements((), mesh)
            assert tsh.batch_pspec(mesh) == tuple(jsh.batch_pspec(jm))
            assert tmesh.dp_axes(mesh) == (("pod", "data") if multi
                                           else ("data",))


def _placement_leaves(tree):
    """(key path, placements) of a tree whose leaves are placement lists."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [k])
        elif isinstance(node, tuple) and hasattr(type(node), "_fields"):
            for f, v in zip(node._fields, node):
                walk(v, path + [f".{f}"])
        elif isinstance(node, (list, tuple)) and node and \
                isinstance(node[0], (list, tuple, dict)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            out.append(("/".join(path), list(node)))
    walk(tree, [])
    return out


def test_collectives_match_reference_parser():
    """The three collectives of ``test_hlo_collective_parser``, issued by
    DTensor on a fake 2 x 2 mesh: an all-gather to bf16 (64, 128), an
    all-reduce of f32 (256,), a reduce-scatter of f32 (8, 16) and (8,).
    Bytes by op and wire bytes are the reference's numbers."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    with _fake_mesh() as mesh:
        def dt(shape, dtype, placements, local):
            return DTensor.from_local(
                torch.empty(local, dtype=dtype, device="meta"), mesh,
                placements, run_check=False, shape=shape,
                stride=torch.empty(shape, device="meta").stride())
        ag = dt((64, 128), torch.bfloat16, [Shard(0), Replicate()],
                (32, 128))
        ar = dt((256,), torch.float32, [Partial(), Replicate()], (256,))
        rs = [dt(s, torch.float32, [Partial(), Replicate()], s)
              for s in ((8, 16), (8,))]
        with thlo.CollectiveRecorder() as rec:
            ag.redistribute(mesh, [Replicate(), Replicate()])
            ar.redistribute(mesh, [Replicate(), Replicate()])
            for x in rs:
                x.redistribute(mesh, [Shard(0), Replicate()])
        st = rec.stats()
    assert st.bytes_by_op["all-gather"] == 64 * 128 * 2
    assert st.bytes_by_op["all-reduce"] == 256 * 4
    assert st.bytes_by_op["reduce-scatter"] == 8 * 16 * 4 + 8 * 4
    assert st.wire_bytes == (64 * 128 * 2) + 2 * (256 * 4) + \
        (8 * 16 * 4 + 8 * 4)
    assert st.raw_bytes == sum(st.bytes_by_op.values())
    assert st.count_by_op == {"all-gather": 1, "all-reduce": 1,
                              "reduce-scatter": 2}
    assert not dist.is_initialized()


@pytest.fixture
def ref_dryrun(monkeypatch):
    """The reference's dry-run module, imported with ``XLA_FLAGS`` kept as
    it was (the module sets a 512-device default at import)."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun
    return dryrun


def test_probe_plan_and_affine_solve(ref_dryrun, monkeypatch):
    """``_probe_plan``'s configs field by field and its combine; the
    affine probe on a cost affine in (L, T) exact, and equal to the
    reference's with zamba2's quadratic correction."""
    for arch in sorted(ARCHS):
        cfg, tcfg = _full(arch)
        (jcfgs, jcomb), (tcfgs, tcomb) = (ref_dryrun._probe_plan(cfg),
                                          tdry._probe_plan(tcfg))
        assert [dataclasses.asdict(c) for c in tcfgs] == \
            [dataclasses.asdict(c) for c in jcfgs], arch
        vals = [3.0, 7.5, 11.25][:len(tcfgs)]
        assert tcomb(*vals) == jcomb(*vals), arch

    def cost(cfg, shape):
        """Affine in (L, T), plus for zamba2 the shared attention's
        quadratic term the probe corrects for."""
        t = shape.seq_len
        flops = 3.0 + 0.5 * t + cfg.n_layers * (7.0 + 0.25 * t)
        if cfg.family == "hybrid":
            b_loc = shape.global_batch // 16
            h_loc = (cfg.n_heads_padded or cfg.n_heads) // cfg.tp
            passes = 4.0 if shape.kind == "train" else 1.0
            flops += passes * cfg.n_layers / cfg.attn_every * \
                2 * 2 * b_loc * h_loc * float(t) ** 2 * cfg.head_dim
        return {"flops": flops, "bytes": 11.0 + cfg.n_layers * 5.0,
                "coll_wire": 2.0, "peak": 1e6 + cfg.n_layers * 64.0 * t}

    class Low:
        def __init__(self, m):
            self.m = m

        def compile(self):
            return self
    monkeypatch.setattr("repro_torch.launch.dryrun._trace_cell",
                        lambda c, s, m, o, unroll: cost(c, s))
    monkeypatch.setattr(ref_dryrun, "_lower_cell",
                        lambda c, s, m, o, unroll: Low(cost(c, s)))
    monkeypatch.setattr(ref_dryrun, "_measure", lambda low: low.m)
    jmesh = type("M", (), {"shape": {"data": 16, "model": 16}})()
    with tmesh.make_production_mesh() as mesh:
        for arch in ("rwkv6-3b", "zamba2-1.2b"):
            cfg, tcfg = _full(arch)
            for name in ("train_4k", "prefill_32k"):
                got = tdry._affine_probe(tcfg, tconf.SHAPES[name], mesh,
                                         tdry._opts(tcfg, SHAPES[name]), None)
                want = ref_dryrun._affine_probe(cfg, SHAPES[name], jmesh,
                                                {"q_chunk": 0}, None)
                assert got["flops"] == pytest.approx(want["flops"],
                                                     rel=1e-9)
                exact = cost(cfg, SHAPES[name])
                for k in ("flops", "bytes", "coll_wire", "peak"):
                    assert got[k] == pytest.approx(exact[k], rel=1e-9)


def test_env_contract(monkeypatch):
    """``cuda_tuned``: opt-in, the user's variable kept, refused with a
    warning once CUDA is up."""
    env = {}
    assert tenv.cuda_tuned(env) is True
    assert env == tenv.CUDA_TUNED_ENV
    assert tenv.cuda_tuned(env) is False          # all set: the user's
    env = {"TORCH_NCCL_HIGH_PRIORITY": "0"}
    assert tenv.cuda_tuned(env) is True
    assert env["TORCH_NCCL_HIGH_PRIORITY"] == "0"
    assert set(env) == set(tenv.CUDA_TUNED_ENV)
    monkeypatch.setattr("torch.cuda.is_initialized", lambda: True)
    env = {}
    with pytest.warns(RuntimeWarning, match="after CUDA init"):
        assert tenv.cuda_tuned(env) is False
    assert env == {}


def test_meshes_leave_no_process_group():
    """The production meshes (256 and 512 ranks), a host mesh and a fake
    world each close their group, also when the block raises; the shard
    mesh needs an open world."""
    assert not dist.is_initialized()
    for multi, n in ((False, 256), (True, 512)):
        with tmesh.make_production_mesh(multi_pod=multi) as mesh:
            assert dist.is_initialized() and dist.get_world_size() == n
            assert mesh.size() == n
            assert mesh.device_type == ("cuda" if torch.cuda.is_available()
                                        else "cpu")
        assert not dist.is_initialized()
    with pytest.raises(KeyError):
        with tmesh.make_production_mesh():
            raise KeyError("inside")
    assert not dist.is_initialized()
    assert tmesh.make_shard_mesh(2) is None
    with tmesh.make_host_mesh(device="cpu") as mesh:
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
        assert dist.get_backend() == "gloo"
        assert tmesh.make_shard_mesh(2) is None
        assert tmesh.make_shard_mesh(1).mesh_dim_names == ("data",)
        with pytest.raises(RuntimeError, match="needs 256"):
            with tmesh.make_production_mesh():
                pass
    assert not dist.is_initialized()


def _reduced(monkeypatch, shapes):
    """Patch the dry run onto a fake 2 x 2 mesh, ``reduced_config`` sizes
    and small shapes of the same kinds."""
    @contextlib.contextmanager
    def production(*, multi_pod=False):
        with _fake_mesh() as mesh:
            yield mesh
    monkeypatch.setattr("repro_torch.launch.mesh.make_production_mesh",
                        production)
    monkeypatch.setattr("repro_torch.configs.get_config",
                        lambda name: tconf.reduced_config(tconf.ARCHS[name]))
    for name, (t, b) in shapes.items():
        monkeypatch.setitem(tconf.SHAPES, name, dataclasses.replace(
            tconf.SHAPES[name], seq_len=t, global_batch=b))


def _ref_result_keys():
    """The keys of the reference's ``run_cell`` result, from its source."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_cell")
    res = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", "") == "result")

    def keys(d):
        out = {}
        for k, v in zip(d.keys, d.values):
            if k is None:          # {**main["mem"], ...}: XLA's four fields
                out.update({m: None for m in
                            ("argument", "output", "temp", "alias")})
            elif isinstance(v, ast.Dict) and k.value in ("memory", "model"):
                out[k.value] = keys(v)
            else:
                out[k.value] = None
        return out
    return keys(res)


def _shape_of(result):
    return {k: (_shape_of(v) if isinstance(v, dict) and k in
                ("memory", "model") else None) for k, v in result.items()}


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-moe-a2.7b"])
def test_run_cell_reduced(arch, monkeypatch):
    """``run_cell`` on a fake 2 x 2 mesh: the reference's keys; argument
    bytes of the full trace equal to the local shards the rules give (the
    parameters, AdamW's moments and step, the batch); the probes' flops,
    bytes and collective bytes equal to the full trace's (a homogeneous
    stack of 4 layers, rel 1e-9); no group left open."""
    _reduced(monkeypatch, {"train_4k": (64, 8), "prefill_32k": (64, 4),
                           "decode_32k": (64, 4)})
    want_keys = _ref_result_keys()
    deep = {"n_layers": 4}
    traces = []
    trace_cell = tdry._trace_cell

    def recording(cfg, *args, **kwargs):
        traces.append((cfg.n_layers, trace_cell(cfg, *args, **kwargs)))
        return traces[-1][1]
    monkeypatch.setattr("repro_torch.launch.dryrun._trace_cell", recording)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        traces.clear()
        full = tdry.run_cell(arch, name, "single", cfg_overrides=deep)
        assert _shape_of(full) == want_keys
        assert full["n_devices"] == 4
        assert not dist.is_initialized()
        if name == "decode_32k":
            assert full["mode"] == "unrolled-exact" and len(traces) == 1
            assert full["memory"]["alias"] > 0     # the cache, in place
            continue
        # the full-depth trace first, then the probes of 1 and 2 layers
        assert [n for n, _ in traces] == [4, 1, 2]
        assert full["mode"] == "unrolled+probe"
        for k, key in (("flops", "flops_per_device"), ("bytes",
                       "bytes_per_device"), ("coll_wire",
                       "collective_bytes_per_device")):
            assert full[key] == pytest.approx(traces[0][1][k], rel=1e-9), \
                (name, k)
        assert full["memory"]["per_device_hbm_bytes"] == traces[0][1]["peak"]
        # the arguments: each leaf's rank-0 shard by the rules
        cfg = dataclasses.replace(
            tconf.get_config(arch).resolve_for_mesh(tp=2), **deep)
        params = tt.init_params(cfg, torch.Generator(), "meta")

        def local(shape, spec):
            n = 1
            for size, entry in zip(shape, list(spec) + [None] * len(shape)):
                ways = 2 if entry is not None else 1
                n *= -(-size // ways)
            return n
        pbytes = sum(local(v.shape, tsh.param_pspec(k, v, name == "train_4k"))
                     * v.element_size() for k, v in _tleaves(params))
        t, b = tconf.SHAPES[name].seq_len, tconf.SHAPES[name].global_batch
        tokens = (b // 2) * t * 4 * (2 if name == "train_4k" else 1)
        want = pbytes * (3 if name == "train_4k" else 1) + tokens + \
            (4 if name == "train_4k" else 0)
        assert full["memory"]["argument"] == want, name
        assert full["flops_per_device"] > 0
        assert full["memory"]["per_device_hbm_bytes"] >= want


def test_cli_writes_the_cell(monkeypatch, tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch --shape --mesh`` prints
    the cell's JSON and writes it under ``RESULTS``; per-device bytes are
    the peak itself, not divided by the device count as the reference
    divides XLA's figure, which is per device already."""
    _reduced(monkeypatch, {"decode_32k": (32, 4)})
    monkeypatch.setattr("repro_torch.launch.dryrun.RESULTS", tmp_path)
    tdry.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
               "--mesh", "multi"])
    out = json.loads(capsys.readouterr().out)
    saved = json.loads((tmp_path / "stablelm-1.6b__decode_32k__multi.json")
                       .read_text())
    assert out == saved and out["mesh"] == "multi"
    mem = out["memory"]
    assert mem["per_device_hbm_bytes"] == mem["argument"] + mem["temp"]
    assert mem["per_device_hbm_bytes"] >= mem["argument"] > 0
    # XLA's memory analysis of an SPMD program is already per device: a
    # (1024, 1024) f32 argument sharded 8 ways reads 4 MiB / 8, which the
    # reference's dry run divides by the device count again
    code = ("import jax, jax.numpy as jnp; "
            "from jax.sharding import NamedSharding, PartitionSpec as P; "
            "m = jax.make_mesh((8,), ('d',)); "
            "s = NamedSharding(m, P('d', None)); "
            "x = jax.ShapeDtypeStruct((1024, 1024), jnp.float32, sharding=s); "
            "c = jax.jit(lambda a: a * 2, out_shardings=s).lower(x).compile(); "
            "print(c.memory_analysis().argument_size_in_bytes)")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    r = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) == 1024 * 1024 * 4 // 8


def test_forward_with_placements_bit_equal_on_one_rank():
    """``forward(boundary_sharding=, logits_sharding=)`` on DTensors of a
    one-rank gloo group (the parameters placed by the rules) equals the
    plain forward bit for bit."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = tconf.reduced_config(tconf.get_config("smollm-135m")) \
        .resolve_for_mesh(tp=1)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    want = tt.forward(params, cfg, tokens)
    with tmesh.make_host_mesh(device="cpu") as mesh:
        pl = tsh.param_placements(params, mesh, fsdp=True)
        dparams = _distribute(params, pl, mesh)
        dtok = DTensor.from_local(tokens, mesh, tsh.data_shardings(
            tokens, mesh))
        with implicit_replication():
            got = tt.forward(dparams, cfg, dtok,
                             boundary_sharding=tsh.placements(
                                 ("data", "model", None), mesh),
                             logits_sharding=tsh.logits_sharding(mesh, 2))
        assert isinstance(got, DTensor)
        assert torch.equal(got.to_local(), want)
    assert not dist.is_initialized()


def _distribute(params, placements, mesh):
    from torch.distributed.tensor import DTensor
    if isinstance(params, dict):
        return {k: _distribute(v, placements[k], mesh)
                for k, v in params.items()}
    if isinstance(params, list):
        return [_distribute(v, p, mesh) for v, p in zip(params, placements)]
    return DTensor.from_local(params, mesh, placements)

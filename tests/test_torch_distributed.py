"""The port's distributed layer against the reference's, on the CPU.

- The reference's three ``Resolver`` cases, case for case, with the spec in
  its tuple form.
- For every leaf of every arch at full size, the port's logical axes and
  ``Resolver.spec`` (a meta-device model, ``param_axes``) equal the
  reference's (``jax.eval_shape(model.init)``, its ``Param.axes``) on both
  production meshes, {data 16, model 16} and {pod 2, data 16, model 16}.
  The reference stacks uniform layers on a leading "layers" axis, which no
  rule maps to a mesh axis; the port's ``ModuleList`` leaves have no such
  axis, so its leaf ``layers.{i}.x`` is held to the reference's
  ``layers.x`` with that axis (and its spec entry, always None) dropped.
- ``placements`` round-trips through ``spec_of``; ``roofline_terms``' units;
  ``collective_bytes`` on a DTensor program traced under a fake group of 2
  ranks in a process of its own: one all-gather, one all-reduce and one
  reduce-scatter, with the reference's byte formulas (exact).
- On a one-rank gloo mesh, the resolver-constrained ``Model.loss`` of yi-9b
  (smoke, fp32 activations, the reference's weights) equals the reference's
  jitted loss within 1e-5 relative (the two packages sum in another order);
  K2 and K3 given DTensors equal their meshless calls exactly, and a layout
  they cannot take raises; so does the decode step's state update
  (``ssd_step``), its state updated in place on the local shards.
- On a (2, 2) gloo mesh in 4 processes (``_mesh_worker.py``), smoke
  llama3.2-3b in fp32: one train step equals the single-process step, the
  loss and every parameter after it within 1e-5 relative; a prefill into a
  cache split on its sequence and one decode step give the single-process
  logits within 1e-5·(1 + max|logit|).  On a (1, 2) mesh in 2 processes,
  one Mamba2 block with its SSM heads split (K3's mesh path, B and C
  whole, their gradients partial) gives the single process's output and
  gradients within 1e-5 relative.  (A whole zamba2 smoke model is no test
  of that: its layer-0 gradients move 5e-4 under a 1e-7 relative change
  of its weights, the rounding floor of fp32.)  Each multi-process run has
  a timeout of 60 s.
"""
import functools
import json
import os
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import _mesh_worker
from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import Resolver as JaxResolver
from repro.models import Model as JaxModel
from repro.models import unbox
from repro.models.common import is_param
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed.hlo_analysis import HBM_BW, NET_BW, PEAK_FLOPS, roofline_terms
from repro_torch.distributed.sharding import Resolver, spec_of
from repro_torch.models import Model
from repro_torch.models.common import param_axes
from repro_torch.models.convert import _UNSTACKED, params_from_jax

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _mesh(sizes):
    """A mesh's axis names and shape, as the port's Resolver reads them;
    nothing is built."""
    return types.SimpleNamespace(mesh_dim_names=tuple(sizes), shape=tuple(sizes.values()))


def _jax_mesh(sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes), devices=np.empty(tuple(sizes.values())))


def _resolver(arch="granite-20b", sizes=MESHES["single"]):
    return Resolver(get_config(arch), _mesh(sizes))


# ------------------------------------------------------- the reference's ----
def test_resolver_divisibility_drops_axis():
    r = _resolver()
    # 48 heads % 16 == 0 → sharded; kv=1 → replicated
    assert r.spec(("embed", "heads", "head"), (6144, 48, 128)) == ("data", "model", None)
    assert r.spec(("embed", "kv_heads", "head"), (6144, 1, 128)) == ("data", None, None)
    # llama3.2: 24 heads % 16 != 0 → dropped
    assert r.spec(("embed", "heads", "head"), (3072, 24, 128)) == ("data", None, None)


def test_resolver_batch_axes_multi_pod():
    r = _resolver("yi-9b", MESHES["multi"])
    assert r.spec(("batch", None), (256, 4096)) == (("pod", "data"), None)
    # batch=1 (long_500k): nothing fits → fully replicated
    assert r.spec(("batch", None), (1, 4096)) == (None, None)


def test_resolver_never_reuses_mesh_axis():
    r = _resolver()
    spec = r.spec(("vocab", "ffn"), (49152, 24576))
    flat = [a for s in spec if s for a in (s if isinstance(s, tuple) else (s,))]
    assert len(flat) == len(set(flat))


# ---------------------------------------------------- every leaf, full size ----
@functools.lru_cache(maxsize=None)
def _reference_leaves(arch):
    """{name: (axes, shape)} of the reference's boxed params, abstractly."""
    boxed = jax.eval_shape(JaxModel(jax_get_config(arch)).init, jax.random.PRNGKey(0))
    flat = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if is_param(val):
                flat[prefix + key] = (tuple(val.axes), tuple(val.value.shape))
            else:
                walk(val, prefix + key + ".")

    walk(boxed, "")
    return flat


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_resolves_as_the_reference(arch, mesh):
    sizes = MESHES[mesh]
    cfg = get_config(arch)
    port = Model(cfg, device="meta")
    shapes = {k: tuple(p.shape) for k, p in port.named_parameters()}
    axes = param_axes(port)
    ours = Resolver(cfg, _mesh(sizes))
    theirs = JaxResolver(jax_get_config(arch), _jax_mesh(sizes))
    seen = set()
    for name, (ref_axes, ref_shape) in _reference_leaves(arch).items():
        ref_spec = tuple(theirs.spec(ref_axes, ref_shape))
        if _UNSTACKED.match(name):
            leaves = [(_UNSTACKED.sub(r"\1.\2\3", name), ref_axes, ref_shape, ref_spec)]
        elif name.startswith("layers."):
            # a stacked leaf: the leading "layers" axis maps to no mesh axis
            assert ref_axes[0] == "layers" and ref_spec[0] is None, (name, ref_axes)
            rest = name[len("layers."):]
            leaves = [(f"layers.{i}.{rest}", ref_axes[1:], ref_shape[1:], ref_spec[1:])
                      for i in range(ref_shape[0])]
        else:
            leaves = [(name, ref_axes, ref_shape, ref_spec)]
        for port_name, want_axes, want_shape, want_spec in leaves:
            assert axes[port_name] == want_axes, port_name
            assert shapes[port_name] == want_shape, port_name
            assert ours.spec(axes[port_name], shapes[port_name]) == want_spec, port_name
            seen.add(port_name)
    assert seen == set(shapes)


def test_placements_round_trip():
    from torch.distributed.tensor import Replicate, Shard

    cfg = get_config("deepseek-67b")
    port = Model(cfg, device="meta")
    for sizes in MESHES.values():
        r = Resolver(cfg, _mesh(sizes))
        for name, p in port.named_parameters():
            spec = r.spec(p.axes, p.shape)
            assert spec_of(r.mesh, r.placements(spec), p.dim()) == spec, name
    r = Resolver(cfg, _mesh(MESHES["multi"]))
    # a dim over two mesh axes is sharded by both, in mesh order
    assert r(("batch", None), (256, 4096)) == (Shard(0), Shard(0), Replicate())
    # wq [8192, 64, 128]: embed → data (FSDP), 64 heads → model
    assert r(("embed", "heads", "head"), (8192, 64, 128)) == (Replicate(), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="against the mesh's order"):
        r.placements(((("data", "pod")), None))


def test_roofline_terms_units():
    cost = {"flops": PEAK_FLOPS, "bytes accessed": HBM_BW}
    terms = roofline_terms(cost, {"bytes_total": NET_BW}, 256)
    assert terms["t_compute"] == pytest.approx(1.0)
    assert terms["t_memory"] == pytest.approx(1.0)
    assert terms["t_collective"] == pytest.approx(1.0)


_COLLECTIVES = r"""
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.fx.experimental.proxy_tensor import make_fx
from repro_torch.distributed.hlo_analysis import collective_bytes

dist.init_process_group("fake", store=FakeStore(), world_size=2, rank=0)
mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))

def program(x, y, z):
    ag = DTensor.from_local(x, mesh, [Shard(0)], run_check=False).redistribute(mesh, [Replicate()])
    ar = DTensor.from_local(y, mesh, [Partial()], run_check=False).redistribute(mesh, [Replicate()])
    rs = DTensor.from_local(z, mesh, [Partial()], run_check=False).redistribute(mesh, [Shard(0)])
    return ag.to_local(), ar.to_local(), rs.to_local()

with FakeTensorMode():
    args = (torch.empty(128, 256), torch.empty(256, 256), torch.empty(256, 256))
    gm = make_fx(program, tracing_mode="fake")(*args)
print(json.dumps(collective_bytes(gm)))
"""


def test_collective_bytes_of_a_traced_dtensor_program():
    out = subprocess.run([sys.executable, "-c", _COLLECTIVES], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["count_all-gather"] == 1
    assert got["count_all-reduce"] == 1
    assert got["count_reduce-scatter"] == 1
    assert got["bytes_all-gather"] == 256 * 256 * 4
    assert got["bytes_all-reduce"] == 2 * 256 * 256 * 4   # ring factor 2
    assert got["bytes_reduce-scatter"] == 128 * 256 * 4
    assert got["bytes_total"] == (256 + 512 + 128) * 256 * 4


# -------------------------------------------------- a one-rank gloo mesh ----
@pytest.fixture
def host_mesh(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_host_mesh("cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["yi-9b", "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b",
                                  "qwen2-vl-72b", "xlstm-1.3b"])
def test_host_mesh_loss_matches_reference(host_mesh, arch):
    """The counterpart of the reference's host-mesh lowering: the
    resolver-constrained loss on the mesh, against the reference's jitted
    loss on the same weights (the MoE families' reference with
    ``scan_layers=False, remat=False``, so that its MoE runs eagerly, as
    tests/test_torch_models.py runs it; vlm with patch embeddings and
    positions3)."""
    import dataclasses

    import jax.numpy as jnp
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import activate, distribute_model
    from test_torch_models import _batch, _to

    eager = {"scan_layers": False, "remat": False} if "moe" in get_config(arch).family else {}
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=jnp.float32, **eager)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    jmodel = JaxModel(jcfg)
    params = unbox(jmodel.init(jax.random.PRNGKey(0)))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    batch = _batch(cfg, 2, 16)
    batch["targets"] = batch["tokens"]
    want = float(jax.jit(jmodel.loss)(params, _to(batch, "jax"))[0])
    r = Resolver(cfg, host_mesh)
    distribute_model(model, r)
    batch = {k: distribute_tensor(v, host_mesh, r(("batch",) + (None,) * (v.dim() - 1), v.shape))
             for k, v in _to(batch, "torch").items()}
    with activate(r):
        loss, _ = model.loss(batch)
    assert type(loss).__name__ == "DTensor"
    assert abs(float(loss.full_tensor()) - want) <= 1e-5 * abs(want)


def test_kernels_take_dtensors_through_local_shards(host_mesh):
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.distributed.sharding import activate
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 40, h, 16, generator=g) for h in (6, 2, 2))
    x = torch.randn(2, 40, 4, 8, generator=g)
    dt, a = torch.rand(2, 40, 4, generator=g), -torch.rand(4, generator=g)
    Bm, Cm = torch.randn(2, 40, 8, generator=g), torch.randn(2, 40, 8, generator=g)
    r = Resolver(get_config("llama3.2-3b", smoke=True), host_mesh)

    def on_mesh(t, axes):
        return distribute_tensor(t, host_mesh, r(axes, t.shape))

    attn = ("batch", "seq", "heads", None)
    with activate(r):
        o = fa_ops.flash_attention(*(on_mesh(t, attn) for t in (q, k, v)))
        y, s = ssd_ops.ssd(on_mesh(x, attn), on_mesh(dt, attn[:3]),
                           on_mesh(Bm, ("batch", "seq", None)),
                           on_mesh(Cm, ("batch", "seq", None)), on_mesh(a, ("heads",)), 16)
    assert torch.equal(o.full_tensor(), fa_ops.flash_attention(q, k, v))
    want_y, want_s = ssd_ops.ssd(x, dt, Bm, Cm, a, 16)
    assert torch.equal(y.full_tensor(), want_y) and torch.equal(s.full_tensor(), want_s)
    # a sequence split reaches the kernel only through a resolver, which
    # makes it whole; without one it raises and is never gathered
    qs, ks, vs = (distribute_tensor(t, host_mesh, [Shard(1)]) for t in (q, k, v))
    with pytest.raises(ValueError, match="heads \\(dim 2\\) split"):
        fa_ops.flash_attention(qs, ks, vs)


@pytest.mark.parametrize("split", ["whole", "batch", "heads"])
def test_ssd_step_takes_dtensors_through_local_shards(host_mesh, split):
    """The decode step's state update given DTensors runs ``ssd_step`` on
    the local shards of the state as it is split (here the plain version,
    on the CPU): the meshless call's y and new state bit for bit, the new
    state written into the DTensor it was given; the other inputs, whole,
    are redistributed to the state's split.  A state split on N raises."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.ssd import ops as ssd_ops

    g = torch.Generator().manual_seed(2)
    B, H, N, P = 2, 4, 8, 12
    state = torch.randn(B, H, N, P, generator=g)
    x = torch.randn(B, H * P, generator=g).bfloat16().view(B, H, P)
    dt = torch.nn.functional.softplus(torch.randn(B, H, generator=g))
    a = -torch.exp(torch.randn(H, generator=g) * 0.3)
    Bm, Cm = torch.randn(B, N, generator=g), torch.randn(B, N, generator=g)
    d_skip = torch.randn(H, generator=g)
    want_state = state.clone()
    want = ssd_ops.ssd_step_plain(want_state, x, dt, a, Bm, Cm, d_skip)
    placement = {"whole": Replicate(), "batch": Shard(0), "heads": Shard(1)}[split]
    st = distribute_tensor(state, host_mesh, [placement])
    rest = [distribute_tensor(t, host_mesh, [Replicate()]) for t in (x, dt, a, Bm, Cm, d_skip)]
    y = ssd_ops.ssd_step(st, *rest)
    assert tuple(y.placements) == (placement,)
    assert torch.equal(y.full_tensor(), want) and torch.equal(st.full_tensor(), want_state)
    on_n = distribute_tensor(state, host_mesh, [Shard(2)])
    with pytest.raises(ValueError, match="batch \\(dim 0\\) and heads \\(dim 1\\) split"):
        ssd_ops.ssd_step(on_n, *rest)


# ------------------------------------------- a (2, 2) mesh in 4 processes ----
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_mesh(tmp_path, what, shape=(2, 2)):
    port, out = _free_port(), tmp_path / f"{what}.pt"
    world = shape[0] * shape[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(os.path.dirname(__file__), "_mesh_worker.py"),
         "--rank", str(rank), "--world", str(world), "--port", str(port),
         "--shape", ",".join(map(str, shape)), "--what", what, "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    try:
        logs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:]
    return torch.load(out)


def test_2x2_mesh_train_step_matches_one_process(tmp_path):
    loss, params = _run_mesh(tmp_path, "train")
    want_loss, want = _mesh_worker.train()
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    assert set(params) == set(want)
    for k, p in want.items():
        assert (params[k] - p).norm() <= 1e-5 * p.norm(), k


def test_2x2_mesh_decode_with_the_cache_split_on_its_sequence(tmp_path):
    got = _run_mesh(tmp_path, "decode")
    for g, w in zip(got, _mesh_worker.decode()):
        assert (g - w).abs().max() <= 1e-5 * (1 + w.abs().max())


@pytest.mark.parametrize("what", sorted(_mesh_worker.FAMILIES))
def test_2x2_mesh_family_matches_one_process(tmp_path, what):
    """One loss forward and backward of the family's smoke model on the
    (2, 2) mesh against one process: the loss and every parameter's
    gradient within 1e-5 relative; each MoE layer's routing decisions
    (top-k experts, kept slots, rows, the tokens each expert row reads, the
    capacity) exactly, their fp32 gates and aux loss within 1e-5 (the
    activations before the router differ in the order of the mesh's sums);
    the routing alone, on the same tokens split on the batch, exactly, the
    gates too."""
    loss, grads, routes, direct = _run_mesh(tmp_path, what)
    want_loss, want, want_routes, want_direct = _mesh_worker.family(what)
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    assert set(grads) == set(want)
    for k, g in want.items():
        assert (grads[k] - g).norm() <= 1e-5 * g.norm(), k
    assert len(routes) == len(want_routes) == (0 if what in ("vlm", "xlstm") else 4)
    exact = ("top_e", "kept", "where", "token_idx")
    for got, w in zip(routes, want_routes):
        assert got["cap"] == w["cap"] and all(torch.equal(got[k], w[k]) for k in exact)
        for k in ("gate", "aux_loss"):
            assert (got[k] - w[k]).norm() <= 1e-5 * w[k].norm()
    if want_direct is not None:
        assert (~want_direct["kept"]).sum() > 0            # slots were dropped
        assert direct["cap"] == want_direct["cap"]
        assert all(torch.equal(direct[k], want_direct[k]) for k in exact + ("gate", "aux_loss"))
        assert torch.equal(torch.bincount(direct["top_e"].reshape(-1)),
                           torch.bincount(want_direct["top_e"].reshape(-1)))
    else:
        assert direct is None


def test_1x2_mesh_mamba2_block_matches_one_process(tmp_path):
    out, grads, grad_x = _run_mesh(tmp_path, "mamba", (1, 2))
    want_out, want, want_x = _mesh_worker.mamba()
    assert (out - want_out).norm() <= 1e-5 * want_out.norm()
    assert (grad_x - want_x).norm() <= 1e-5 * want_x.norm()
    assert set(grads) == set(want)
    for k, g in want.items():
        assert (grads[k] - g).norm() <= 1e-5 * g.norm(), k

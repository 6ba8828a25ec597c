"""The port's mesh paths on 1, 2 and 4 gloo ranks against the
reference's ``shard_map`` regions on as many XLA host devices, with the
same weights and inputs through numpy.

* ``moe_ffn_sharded`` (mesh (1, n): experts and the sequence over
  ``model``): output, aux losses, and the gradients in x, the router and
  the expert weights.  Float32 on both sides, sums in different orders:
  the output and the gradients at rtol 1e-5 / 1e-4 with atol 1e-6 x the
  largest magnitude (``tests/test_torch_moe.py``'s bounds), the losses
  at rtol 1e-5.  The dropped (token, choice) pairs are compared exactly:
  the port's are recorded from its ``expert_positions`` calls, the
  reference's computed from its routing and per-device capacity.
* the row-sharded embedding lookup (mesh (1, n), and (2, 2) at 4 ranks):
  bit for bit, unpadded, padded and chunked batches.
* a one-rank run against the one-device path: the lookup bit for bit,
  the MoE against ``moe_ffn`` at the same (per-device) capacity.
* ``act.constrain`` redistributes a DTensor under a context.

The ranks are child processes (this file run as a script), and so is the
reference, with ``--xla_force_host_platform_device_count=4``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ME = str(Path(__file__).resolve())
E, K, D, F_FF, CF = 8, 2, 16, 24, 1.0
B, S = 2, 16
VOCABS = (96, 40, 200)  # real rows; the tables pad to a multiple of 8
LOOKUP_B = {"plain": 24, "padded": 21, "chunked": 50}
CHUNK = 16
MESHES = {1: (1, 1), 2: (1, 2), 4: (1, 4), "2x2": (2, 2)}


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu", **extra)


def _inputs(path):
    rng = np.random.default_rng(0)
    f32 = np.float32
    arrays = {
        "x": rng.standard_normal((B, S, D)).astype(f32),
        "cot": rng.standard_normal((B, S, D)).astype(f32),
        "router": (D ** -0.5 * rng.standard_normal((D, E))).astype(f32),
        "w_gate": (D ** -0.5 * rng.standard_normal((E, D, F_FF))).astype(f32),
        "w_up": (D ** -0.5 * rng.standard_normal((E, D, F_FF))).astype(f32),
        "w_down": (F_FF ** -0.5 * rng.standard_normal((E, F_FF, D))
                   ).astype(f32),
    }
    for i, v in enumerate(VOCABS):
        arrays[f"table{i}"] = rng.standard_normal((-(-v // 8) * 8, 8)
                                                  ).astype(f32)
    for name, b in LOOKUP_B.items():
        arrays[f"ids_{name}"] = np.stack(
            [rng.integers(0, v, b) for v in VOCABS], 1).astype(np.int32)
    np.savez(path, **arrays)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_paths")
    _inputs(d / "in.npz")
    ref = subprocess.Popen(
        [sys.executable, ME, "reference", str(d)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    for n in (1, 2, 4):
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, ME, "rank", str(d),
                                   str(n), str(r), str(port)], env=_env())
                 for r in range(n)]
        for p in procs:
            assert p.wait(timeout=300) == 0
    assert ref.wait(timeout=300) == 0
    return d


def _close(got, want, rtol, what):
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale,
                               err_msg=what)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_moe_ffn_sharded_matches_reference(runs, n):
    got = np.load(runs / f"port_{n}.npz")
    want = np.load(runs / f"ref_{n}.npz")
    _close(got["y"], want["y"], 1e-5, "y")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for name in ("x", "router", "w_gate", "w_up", "w_down"):
        _close(got[f"g_{name}"], want[f"g_{name}"], 1e-4, name)
    assert got["dropped"].tolist() == want["dropped"].tolist()
    if n == 4:
        assert len(want["dropped"]) > 0  # the capacity bites


@pytest.mark.parametrize("n", [1, 2, 4, "2x2"])
def test_row_sharded_lookup_bit_for_bit(runs, n):
    got = np.load(runs / f"port_{n}.npz")
    want = np.load(runs / f"ref_{n}.npz")
    for name in LOOKUP_B:
        a, b = got[f"lookup_{name}"], want[f"lookup_{name}"]
        assert a.shape == b.shape == (LOOKUP_B[name], len(VOCABS), 8)
        assert a.tobytes() == b.tobytes(), name


def test_one_rank_equals_one_device_path(runs):
    got = np.load(runs / "port_1.npz")
    for name in LOOKUP_B:
        assert got[f"lookup_{name}"].tobytes() == \
            got[f"plain_lookup_{name}"].tobytes()
    _close(got["y"], got["plain_y"], 1e-5, "y")
    np.testing.assert_allclose(got["losses"], got["plain_losses"], rtol=1e-6)


def test_constrain_redistributes_under_a_context(runs):
    got = json.loads((runs / "constrain_2.json").read_text())
    assert got == {"outside": True, "placements": "(Replicate(), Shard(dim=1))",
                   "same_values": True}


# ------------------------------------------------------------ reference
def _ref_dropped(x, router, mesh_n):
    """(global token, choice) pairs over capacity: the reference's
    routing and per-device capacity on each device's tokens."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe

    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    idx = np.asarray(idx)
    sl = S // mesh_n
    out = []
    for r in range(mesh_n):
        loc = idx[:, r * sl:(r + 1) * sl]  # (B, sl, K)
        t_loc = B * sl
        cap = max(1, -(-int(CF * t_loc * K) // E))
        pos = np.asarray(jmoe.expert_positions(jnp.asarray(loc.reshape(-1)),
                                               E))
        for i in np.nonzero(pos >= cap)[0]:
            t, j = divmod(int(i), K)
            b, s = divmod(t, sl)
            out.append((b * S + r * sl + s, j))
    return np.array(sorted(out), np.int64).reshape(-1, 2)


def _reference(d):
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    from repro.models import recsys as jrec
    from repro.ps import act_sharding as jact

    a = dict(np.load(Path(d) / "in.npz"))
    cfg = jmoe.MoEConfig(n_experts=E, top_k=K, d_ff=F_FF, capacity_factor=CF)
    names = ("router", "w_gate", "w_up", "w_down")
    for n, shape in MESHES.items():
        devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
        mesh = jax.sharding.Mesh(devs, ("data", "model"))
        res = {}
        with jact.activate(mesh):
            if n != "2x2":
                def f(x, p):
                    y, losses = jmoe.moe_ffn_sharded(x, p, cfg)
                    return jnp.sum(y * a["cot"]) + losses, (y, losses)

                p = {k: jnp.asarray(a[k]) for k in names}
                (_, (y, losses)), (gx, gp) = jax.jit(jax.value_and_grad(
                    f, argnums=(0, 1), has_aux=True))(jnp.asarray(a["x"]), p)
                res.update(y=np.asarray(y), losses=np.asarray(losses),
                           g_x=np.asarray(gx),
                           dropped=_ref_dropped(a["x"], a["router"],
                                                shape[1]),
                           **{f"g_{k}": np.asarray(gp[k]) for k in names})
            tables = [jnp.asarray(a[f"table{i}"]) for i in range(len(VOCABS))]
            for name in LOOKUP_B:
                res[f"lookup_{name}"] = np.asarray(jax.jit(
                    lambda t, i: jrec.sharded_embedding_lookup(
                        t, i, chunk=CHUNK))(tables,
                                            jnp.asarray(a[f"ids_{name}"])))
        np.savez(Path(d) / f"ref_{n}.npz", **res)


# ----------------------------------------------------------------- ranks
def _rank(d, n, rank, port):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models import moe as tmoe
    from repro_torch.models import recsys as trec
    from repro_torch.ps import act_sharding as act

    n, rank = int(n), int(rank)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n)
    a = {k: torch.from_numpy(v) for k, v in np.load(Path(d) / "in.npz").items()}
    cfg = tmoe.MoEConfig(n_experts=E, top_k=K, d_ff=F_FF, capacity_factor=CF)
    names = ("router", "w_gate", "w_up", "w_down")
    tables = [a[f"table{i}"] for i in range(len(VOCABS))]
    for mesh_key in ([n, "2x2"] if n == 4 else [n]):
        mesh = init_device_mesh("cpu", MESHES[mesh_key],
                                mesh_dim_names=("data", "model"))
        res = {}
        with act.activate(mesh):
            for name in LOOKUP_B:
                out = trec.sharded_embedding_lookup(tables, a[f"ids_{name}"],
                                                    chunk=CHUNK)
                res[f"lookup_{name}"] = out.full_tensor().numpy()
        if mesh_key != "2x2":
            x = a["x"].clone().requires_grad_(True)
            p = {k: a[k].clone().requires_grad_(True) for k in names}
            seen = []
            real = tmoe.expert_positions

            def recording(eid, e):
                pos = real(eid, e)
                seen.append((eid.clone(), pos.clone()))
                return pos

            tmoe.expert_positions = recording
            with act.activate(mesh):
                y, losses = tmoe.moe_ffn_sharded(x, p, cfg)
                loss = (y * act.as_dtensor(a["cot"], mesh)).sum() + losses
            tmoe.expert_positions = real
            loss.full_tensor().backward()
            res.update(y=y.full_tensor().detach().numpy(),
                       losses=losses.full_tensor().detach().numpy(),
                       g_x=x.grad.numpy(),
                       **{f"g_{k}": p[k].grad.numpy() for k in names})
            (eid, pos), = seen
            sl = S // MESHES[mesh_key][1]
            cap = max(1, -(-int(CF * B * sl * K) // E))
            mine = [((t // K) // sl * S + rank * sl + (t // K) % sl, t % K)
                    for t in torch.nonzero(pos >= cap)[:, 0].tolist()]
            gathered = [None] * n
            dist.all_gather_object(gathered, mine)
            res["dropped"] = np.array(sorted(sum(gathered, [])),
                                      np.int64).reshape(-1, 2)
            if n == 1:  # the one-device paths on the same inputs
                for name in LOOKUP_B:
                    res[f"plain_lookup_{name}"] = \
                        trec.sharded_embedding_lookup(
                            tables, a[f"ids_{name}"]).numpy()
                py, pl = tmoe.moe_ffn(a["x"].reshape(B * S, D),
                                      {k: a[k] for k in names}, cfg,
                                      capacity=max(1, -(-int(
                                          CF * B * S * K) // E)))
                res["plain_y"] = py.reshape(B, S, D).numpy()
                res["plain_losses"] = pl.numpy()
            if n == 2:
                t = torch.arange(32.0).reshape(4, 8)
                dt = DTensor.from_local(t, mesh, [Replicate(), Replicate()])
                outside = act.constrain(dt, None, "tp") is dt
                with act.activate(mesh):
                    got = act.constrain(dt, None, "tp")
                same = bool(torch.equal(got.full_tensor(), t))  # every rank
                if rank == 0:
                    (Path(d) / "constrain_2.json").write_text(json.dumps({
                        "outside": outside,
                        "placements": str(tuple(got.placements)),
                        "same_values": same}))
        if rank == 0:
            np.savez(Path(d) / f"port_{mesh_key}.npz", **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _rank(*sys.argv[2:6])

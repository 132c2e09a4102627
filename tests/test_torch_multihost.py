"""Meshes across OS processes in the port, against the JAX package and the
one-process mesh: the twin of ``tests/test_multihost.py``.

Two OS processes join one ``torch.distributed`` world with gloo on the CPU,
booted by ``initialize_distributed`` from the JAX package's three variables,
and each drives two CPU positions of one ``process_mesh``. The children are
this file run as a script (``python tests/test_torch_multihost.py --child
<dir>``); one pair runs every leg, and each writes what it computed to
``<dir>/rank<r>.pkl`` for the tests here to hold:

- ``twin``: a data-axis sum over {"data": 4} and ``iris_mlp``'s forward
  through a ``ModelRuntime`` on the JAX build's weights, each process
  feeding and reading only its own rows;
- ``collectives``: ``psum``, ``all_gather``, ``all_to_all`` and
  ``ppermute`` along both axes of {"data": 2, "model": 2} ("data" across
  the processes) and {"model": 2, "data": 2} ("model" across them), and
  the gradients of a loss over their answers;
- ``train``: BERT's sharded step over {"data": 2, "model": 2}, AdamW,
  "data" across the processes.

Tolerances: the sum and the collectives' values exactly (a sum of two
terms, or copies); their gradients at rtol 1e-6 (a sum of up to four
terms in another order); ``iris_mlp`` at JAX's twin's rtol 1e-5 / atol
1e-6; the train step's losses at rtol 1e-4 and each leaf's update within
0.25 of the reference's in norm, as ``tests/test_torch_sharded_training.py``
holds the one-process step.
"""

from __future__ import annotations

import asyncio
import datetime
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
N_PROCS = 2
CHILD_TIMEOUT_S = 120.0
CPU = torch.device("cpu")
MESHES = ({"data": 2, "model": 2}, {"model": 2, "data": 2})
OPS = ("psum", "all_gather", "all_to_all", "ppermute")
TRAIN_LR, TRAIN_STEPS = 5e-3, 3


def _bert_batch():
    from seldon_core_tpu_torch.models.bert import init_bert

    params = init_bert(0, vocab=64, hidden=128, layers=1, ffn=128, max_len=16, num_classes=2)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, (4, 16)).astype(np.int32)
    y = rng.integers(0, 2, (4,)).astype(np.int32)
    return params, x, y


def _collective(op: str, shards, mesh, axis: str):
    from seldon_core_tpu_torch.parallel import collectives as c

    n = mesh.global_shape[axis]
    if op == "psum":
        return c.psum(shards, mesh, axis)
    if op == "all_gather":
        return c.all_gather(shards, mesh, axis, dim=1)
    if op == "all_to_all":
        return c.all_to_all(shards, mesh, axis, split_dim=1, concat_dim=0)
    return c.ppermute(shards, mesh, axis, [(i, (i + 1) % n) for i in range(n)])


def collective_cases(mesh) -> dict:
    """Per (mesh, axis, op): each position's answer and its input's
    gradient under the loss sum over positions of <answer, W[position]>,
    keyed by global position (a one-process mesh gives them all)."""
    rng = np.random.default_rng(5)
    xs_all = rng.standard_normal((4, 4, 8)).astype(np.float32)
    out = {}
    for axis in mesh.axis_names:
        for op in OPS:
            xs = [torch.from_numpy(xs_all[mesh.global_index(p)]).clone().requires_grad_(True)
                  for p in range(mesh.size)]
            ys = _collective(op, xs, mesh, axis)
            w = np.random.default_rng(6).standard_normal((4, *ys[0].shape)).astype(np.float32)
            loss = sum((y * torch.from_numpy(w[mesh.global_index(p)])).sum() for p, y in enumerate(ys))
            loss.backward()
            out[(axis, op)] = {mesh.global_index(p): (ys[p].detach().numpy(), xs[p].grad.numpy())
                               for p in range(mesh.size)}
    return out


def _child(out_dir: str) -> int:
    """One process of the pair: every leg, its results pickled."""
    import torch.distributed as dist

    from seldon_core_tpu_torch.models.base import ModelRuntime
    from seldon_core_tpu_torch.models.bert import bert_logits_factory, bert_pspecs
    from seldon_core_tpu_torch.models.zoo import get_model
    from seldon_core_tpu_torch.parallel import gather_params, initialize_distributed, place_params, process_mesh
    from seldon_core_tpu_torch.parallel.collectives import psum, shard
    from seldon_core_tpu_torch.parallel.distributed import counters
    from seldon_core_tpu_torch.training.steps import adamw, make_sharded_train_step

    backend = initialize_distributed()
    rank = dist.get_rank()
    res: dict = {"backend": backend, "rank": rank}

    # twin: a data-axis sum, then iris_mlp's forward on each process's rows
    mesh = process_mesh({"data": 4}, [CPU, CPU])
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    local = torch.from_numpy(full[rank * 4:(rank + 1) * 4])
    parts = [(x * 2.0 + 1.0).sum() for x in shard(local, mesh, {"data": 0})]
    res["sum"] = [float(t) for t in psum(parts, mesh, "data")]
    with open(Path(out_dir) / "iris.pkl", "rb") as f:
        iris = pickle.load(f)
    spec = get_model("iris_mlp", seed=3)
    rt = ModelRuntime(spec.apply_fn, iris, mesh=mesh, buckets=(4,))
    x_full = np.linspace(-1.0, 1.0, 32, dtype=np.float32).reshape(8, 4)
    res["iris_rows"] = rt.predict(x_full[rank * 4:(rank + 1) * 4])
    res["iris_buckets"] = rt.buckets

    # collectives along both axes of two layouts
    res["collectives"] = {tuple(axes): collective_cases(process_mesh(axes, [CPU, CPU])) for axes in MESHES}

    # BERT's sharded step, "data" across the processes and "model" within
    params, x, y = _bert_batch()
    mesh = process_mesh({"data": 2, "model": 2}, [CPU, CPU])
    step, state, _ = make_sharded_train_step(bert_logits_factory(mesh), adamw(TRAIN_LR), mesh, bert_pspecs(params),
                                             init_params=params)
    losses = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, {"x": x[rank * 2:(rank + 1) * 2], "y": y[rank * 2:(rank + 1) * 2]})
        losses.append(float(m["loss"]))
    from seldon_core_tpu_torch.models.convert import tree_map

    res["losses"] = losses
    res["params"] = tree_map(lambda t: t.detach().numpy(), gather_params(state.params))

    # "model" across the processes: each holds half the blocks, which
    # neither a gather nor a runtime takes
    mesh = process_mesh({"model": 2, "data": 2}, [CPU, CPU])
    placed = place_params(params, bert_pspecs(params), mesh, lambda a, dev: torch.as_tensor(a))
    res["refused"] = []
    for attempt in (lambda: gather_params(placed), lambda: ModelRuntime(spec.apply_fn, iris, mesh=mesh)):
        try:
            attempt()
            res["refused"].append("")
        except ValueError as e:
            res["refused"].append(str(e))
    res["counters"] = counters()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(out_dir: Path) -> list[dict]:
    """The two children, each with its variables, a timeout, and both
    killed when either fails."""
    port = _free_port()
    procs = []
    for pid in range(N_PROCS):
        env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES=str(N_PROCS), JAX_PROCESS_ID=str(pid), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, __file__, "--child", str(out_dir)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=CHILD_TIMEOUT_S)
    logs = []
    try:
        for p in procs:
            left = max(1.0, (deadline - datetime.datetime.now()).total_seconds())
            out, _ = p.communicate(timeout=left)
            logs.append(out)
            if p.returncode != 0:
                raise AssertionError(f"child rc {p.returncode}:\n{out[-3000:]}")
    except subprocess.TimeoutExpired:
        raise AssertionError("a multihost child timed out") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank in range(N_PROCS):
        with open(out_dir / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    import jax

    from seldon_core_tpu.models.zoo import get_model as jax_get_model
    from seldon_core_tpu_torch.models.convert import carry_params
    from seldon_core_tpu_torch.models.zoo import get_model

    out = tmp_path_factory.mktemp("multihost")
    jms = jax_get_model("iris_mlp", seed=3)
    with open(out / "iris.pkl", "wb") as f:
        pickle.dump(carry_params(get_model("iris_mlp", seed=3).params, jax.tree.map(np.asarray, jms.params)), f)
    return launch(out), jms


def test_two_processes_match_jax_single_process(children):
    """The twin of ``tests/test_multihost.py:74``: the global sum each
    process reads is JAX's single-process value, and the processes' rows of
    ``iris_mlp`` (carried weights) stitch into JAX's forward."""
    import jax

    results, jms = children
    assert [r["backend"] for r in results] == ["gloo", "gloo"]
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    for r in results:
        assert r["sum"] == [float(np.sum(full * 2.0 + 1.0))] * 2
        assert r["iris_buckets"] == (4,)
    x_full = np.linspace(-1.0, 1.0, 32, dtype=np.float32).reshape(8, 4)
    want = np.asarray(jax.jit(jms.apply_fn)(jms.params, x_full))
    got = np.concatenate([r["iris_rows"] for r in results])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("axes", [tuple(a) for a in MESHES], ids=lambda a: "x".join(a))
@pytest.mark.parametrize("op", OPS)
def test_collectives_across_processes_match_one_process(children, axes, op):
    """Along each axis, the processes' answers and gradients are the
    one-process mesh's of the same four positions."""
    from seldon_core_tpu_torch.parallel import Mesh

    results, _ = children
    mesh_axes = dict.fromkeys(axes, 2)
    want = collective_cases(Mesh(mesh_axes, [CPU] * 4))
    for axis in axes:
        got = {}
        for r in results:
            got.update(r["collectives"][axes][(axis, op)])
        assert sorted(got) == [0, 1, 2, 3]
        for gp, (y, g) in got.items():
            wy, wg = want[(axis, op)][gp]
            np.testing.assert_array_equal(y, wy, err_msg=f"{axes} {axis} {op} position {gp}")
            np.testing.assert_allclose(g, wg, rtol=1e-6, atol=1e-7, err_msg=f"{axes} {axis} {op} grad {gp}")
    calls, staged = results[0]["counters"]["cross_process_calls"], results[0]["counters"]["staged_bytes"]
    assert min(calls.values()) > 0, calls  # every kind crossed the boundary
    assert staged == dict.fromkeys(staged, 0)  # CPU tensors: nothing goes through the host


def test_two_process_train_step_matches_one_process_and_jax(children):
    """BERT's step over {"data": 2, "model": 2} with "data" across the two
    processes: each step's loss (the same on both) is the one-process mesh
    step's and JAX's sharded step's, and each leaf's update after the steps
    is theirs."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh as JaxMesh

    from seldon_core_tpu.models.bert import bert_logits as jax_bert_logits
    from seldon_core_tpu.models.bert import bert_pspecs as jax_bert_pspecs
    from seldon_core_tpu.training.steps import make_sharded_train_step as jax_make_sharded_train_step
    from seldon_core_tpu_torch.models.bert import bert_logits_factory, bert_pspecs
    from seldon_core_tpu_torch.parallel import Mesh, gather_params
    from seldon_core_tpu_torch.training.steps import adamw, make_sharded_train_step, tree_leaves

    results, _ = children
    params, x, y = _bert_batch()
    assert results[0]["losses"] == results[1]["losses"]
    mesh = Mesh({"data": 2, "model": 2}, [CPU] * 4)
    step, state, _ = make_sharded_train_step(bert_logits_factory(mesh), adamw(TRAIN_LR), mesh, bert_pspecs(params),
                                             init_params=params)
    one = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, {"x": x, "y": y})
        one.append(float(m["loss"]))
    axes = {"data": 2, "model": 2}
    jmesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), tuple(axes))
    jstep, jstate, jbatch = jax_make_sharded_train_step(jax_bert_logits, optax.adamw(TRAIN_LR), jmesh,
                                                        jax_bert_pspecs(params), init_params=params)
    jx, jy = jax.device_put(jnp.asarray(x), jbatch["x"]), jax.device_put(jnp.asarray(y), jbatch["y"])
    jax_losses = []
    for _ in range(TRAIN_STEPS):
        jstate, jm = jstep(jstate, {"x": jx, "y": jy})
        jax_losses.append(float(jm["loss"]))
    got = results[0]["losses"]
    np.testing.assert_allclose(got, one, rtol=1e-4)
    np.testing.assert_allclose(got, jax_losses, rtol=1e-4)

    def leaves_like(own, other):
        if isinstance(own, dict):
            return [v for k in own for v in leaves_like(own[k], other[k])]
        if isinstance(own, (list, tuple)):
            return [v for a, b in zip(own, other) for v in leaves_like(a, b)]
        return [np.asarray(other, np.float64)]

    init = [np.asarray(a, np.float64) for a in tree_leaves(params)]
    for r in results:
        mine = [np.asarray(a, np.float64) for a in tree_leaves(r["params"])]
        for want in ([t.detach().numpy().astype(np.float64) for t in tree_leaves(gather_params(state.params))],
                     leaves_like(params, jstate.params)):
            for g, w, p0 in zip(mine, want, init):
                assert np.linalg.norm(g - w) <= 0.25 * np.linalg.norm(w - p0), (np.linalg.norm(g - w),
                                                                               np.linalg.norm(w - p0))
    for a, b in zip(tree_leaves(results[0]["params"]), tree_leaves(results[1]["params"])):
        np.testing.assert_array_equal(a, b)  # every copy took the same update


def test_what_a_process_does_not_hold_is_refused_by_name(children):
    """With "model" across the processes each holds half the blocks: a
    gather of the parameters and a runtime (which feeds each process's own
    rows) refuse the mesh by name, on both processes."""
    results, _ = children
    for r in results:
        gather, runtime = r["refused"]
        assert "held by other processes only" in gather
        assert "axis 'model' spans 2 processes; only 'data' may cross processes" in runtime


# ------------------------------------------------------- initialize_distributed


def test_initialize_distributed_does_nothing_without_a_coordinator(monkeypatch):
    import torch.distributed as dist

    from seldon_core_tpu_torch.parallel import initialize_distributed

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: pytest.fail("init_process_group called"))
    assert initialize_distributed() is None
    assert initialize_distributed(num_processes=2, process_id=1) is None


@pytest.mark.parametrize("env,args,cards,want", [
    ({"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "3"}, {}, 0,
     ("tcp://10.0.0.1:1234", 4, 3, "gloo")),
    ({"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "3"},
     {"coordinator": "h:9", "num_processes": 2, "process_id": 0, "backend": "nccl"}, 0, ("tcp://h:9", 2, 0, "nccl")),
    ({"JAX_COORDINATOR_ADDRESS": "h:9"}, {}, 0, ("tcp://h:9", 1, 0, "gloo")),
    ({"JAX_COORDINATOR_ADDRESS": "h:9", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}, {}, 1,
     ("tcp://h:9", 2, 1, "nccl")),
])
def test_initialize_distributed_reads_the_jax_variables_and_arguments_win(monkeypatch, env, args, cards, want):
    """The JAX package's variables and defaults; arguments override them;
    the processes meet at the coordinator's store and report their hosts
    there (the other processes' reports are planted in an in-memory store,
    each on a host of its own with ``cards`` cards); the backend is gloo
    where a host lacks a card for each process, nccl where each has one,
    and a NCCL request is passed on as it is (never swapped for gloo)."""
    import torch.distributed as dist

    from seldon_core_tpu_torch.parallel import distributed

    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    store, seen, met = dist.HashStore(), {}, []
    n, rank = want[1], want[2]
    for r in range(n):
        if r != rank:
            dist.PrefixStore(distributed.HOSTS_PREFIX, store).set(str(r), f'["host{r}", {cards}]')
    monkeypatch.setattr(distributed, "host_report", lambda: ("here", cards))
    monkeypatch.setattr(distributed, "_rendezvous", lambda c, r, w, t: met.append((f"tcp://{c}", w, r)) or store)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.update(kw))
    monkeypatch.setattr(dist, "barrier", lambda: None)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.update(card=d))
    if want[3] == "nccl" and not cards:
        monkeypatch.setenv("LOCAL_RANK", "0")  # a host without cards: the launcher names the card
    assert distributed.initialize_distributed(**args) == want[3]
    assert met == [want[:3]]
    assert (seen["world_size"], seen["rank"], seen["backend"]) == want[1:]
    assert isinstance(seen["store"], dist.PrefixStore)
    assert ("device_id" in seen) == (want[3] == "nccl")
    if want[3] == "nccl":
        assert seen["card"] == seen["device_id"] == torch.device("cuda", 0)


def test_initialize_distributed_refuses_a_bad_backend_or_rank(monkeypatch):
    from seldon_core_tpu_torch.parallel import initialize_distributed

    with pytest.raises(ValueError, match="backend must be one of"):
        initialize_distributed("h:1", 2, 0, backend="mpi")
    with pytest.raises(ValueError, match="process id 2 is not one of 2"):
        initialize_distributed("h:1", 2, 2)


def test_backend_choice(monkeypatch):
    """nccl only where every host has a card for each of its processes,
    from the hosts the processes report (no launcher variable needed)."""
    from seldon_core_tpu_torch.parallel.distributed import choose_backend

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert choose_backend([("a", 1), ("a", 1)]) == "gloo"  # two processes on the one card
    assert choose_backend([("a", 1)]) == "nccl"
    assert choose_backend([("a", 1), ("b", 1)]) == "nccl"  # two hosts, a card each
    assert choose_backend([("a", 2), ("a", 2), ("b", 2), ("b", 2)]) == "nccl"
    assert choose_backend([("a", 2), ("a", 2), ("b", 1), ("b", 1)]) == "gloo"
    assert choose_backend([("a", 0), ("b", 0)]) == "gloo"  # the CPU
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")  # a launcher's count does not decide it
    assert choose_backend([("a", 1), ("a", 1)]) == "gloo"


@pytest.mark.parametrize("hosts,want", [
    ([("a", 1), ("b", 1)], [0, 0]),  # two hosts with one card each
    ([("a", 2), ("a", 2), ("b", 2), ("b", 2)], [0, 1, 0, 1]),
    ([("a", 2), ("b", 2), ("a", 2), ("b", 2)], [0, 0, 1, 1]),
    ([("a", 4), ("a", 4), ("a", 4)], [0, 1, 2]),
])
def test_the_card_of_each_process(monkeypatch, hosts, want):
    """Under NCCL a process drives its index among its host's processes:
    card 0 on each of two one-card hosts (not ``rank``, which names no card
    on the second host); ``LOCAL_RANK`` wins where a launcher sets it; a
    host without a card for the process is refused by name."""
    from seldon_core_tpu_torch.parallel.distributed import card_index

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert [card_index(hosts, r) for r in range(len(hosts))] == want
    with pytest.raises(ValueError, match="process 1 of host 'a', which has 1 cards"):
        card_index([("a", 1), ("a", 1)], 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert [card_index(hosts, r) for r in range(len(hosts))] == [0] * len(hosts)
    assert card_index([("a", 1), ("a", 1)], 1) == 0


@pytest.mark.parametrize("axes,local,want", [
    ({"data": 2, "model": 2}, [0, 1], {"data": 1, "model": 2}),
    ({"data": 2, "model": 2}, [2, 3], {"data": 1, "model": 2}),
    ({"model": 2, "data": 2}, [2, 3], {"model": 1, "data": 2}),
    ({"data": 4, "model": 2}, [4, 5, 6, 7], {"data": 2, "model": 2}),
    ({"data": 2, "model": 2}, [3], {"data": 1, "model": 1}),
    ({"data": 4}, [2, 3], {"data": 2}),
])
def test_a_process_holds_one_aligned_block_of_the_mesh(axes, local, want):
    """Positions laid out rank-major give each process a block of the
    global array: its shape is what the process's mesh calls ``shape``."""
    from seldon_core_tpu_torch.parallel.mesh import _local_block

    assert _local_block(axes, local) == want


@pytest.mark.parametrize("axes,local", [({"data": 2, "model": 2}, [1, 2]), ({"data": 2, "model": 3}, [0, 1]),
                                        ({"data": 4}, [0, 2])])
def test_positions_that_are_no_aligned_block_are_refused(axes, local):
    from seldon_core_tpu_torch.parallel.mesh import _local_block

    with pytest.raises(ValueError, match="aligned block|do not tile"):
        _local_block(axes, local)


def test_the_server_joins_the_processes_before_it_builds(monkeypatch):
    """The CLI calls ``initialize_distributed`` before anything builds a
    model, as the JAX server's ``_amain`` does."""
    import argparse

    from seldon_core_tpu_torch.serving import server as server_mod

    calls = []

    class Booted(Exception):
        pass

    def load(*args):
        calls.append("load")
        raise Booted

    monkeypatch.setattr(server_mod, "initialize_distributed", lambda: calls.append("init"))
    monkeypatch.setattr(server_mod, "load_predictor", load)
    with pytest.raises(Booted):
        asyncio.run(server_mod._amain(argparse.Namespace(deployment="d.json", predictor=None)))
    assert calls == ["init", "load"]


def test_a_served_mesh_across_processes_is_refused_by_name(monkeypatch):
    """JAX builds a served {"data": 4} over two processes of two devices,
    and a request sent to one process waits on the other: the port refuses
    a served mesh larger than the process's positions in a world of
    several processes, at build; one this process holds still serves."""
    import json

    from seldon_core_tpu_torch.graph.spec import SeldonDeployment
    from seldon_core_tpu_torch.serving import server as server_mod

    dep = json.loads((ROOT / "seldon_core_tpu_torch/deployments/iris.json").read_text())
    dep["spec"]["predictors"][0]["tpu"]["mesh"] = {"data": 4}
    pred = SeldonDeployment.from_dict(dep).spec.predictors[0]
    monkeypatch.setattr(server_mod, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="spans processes"):
        server_mod.PredictorServer(pred, device="cpu", mesh_devices=[CPU, CPU])
    dep["spec"]["predictors"][0]["tpu"]["mesh"] = {"data": 2}
    server = server_mod.PredictorServer(SeldonDeployment.from_dict(dep).spec.predictors[0], device="cpu",
                                        mesh_devices=[CPU, CPU])
    assert server.mesh.shape == {"data": 2}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(_child(sys.argv[2]))

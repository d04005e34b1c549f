"""The port's sharded tempering (``tempering_sweep_chunk_sharded``,
``TemperingContainer.shard_over``) on four gloo ranks on the CPU:

- the chunk on JAX's per-device draws against the JAX package's
  ``tempering_sweep_chunk_sharded`` on a 4-device CPU mesh (``cluster_caps
  =None``): op strings, states, labels, heat-bath tables, parity, swap
  count and samples bit-equal, for a homogeneous, a heterogeneous
  heat-bath and a signed ladder. JAX's device ``d`` draws its sweep from
  ``k_sweep = fold_in(fold_in(fold_in(key, t), 0), d)`` (split five ways
  as ``_sweep_impl`` splits a key) and its swap from ``k_swap =
  fold_in(fold_in(key, t), 1)``; this process computes those draws, so the
  ranks import no JAX;
- the chunk on ``BlockDraws`` against the port's unsharded chunk on the
  same uniforms, at h = 0: equal;
- the oracles of ``tests/test_tempering_sharded.py`` on the port's
  container (``torch_dist_workers.container_oracles``), the ranks' growth
  decisions, samples and fingerprints equal, a sharded checkpoint resumed
  equal;
- ``shard_over`` without a process group raises; ``dryrun_sharded``.

Every spawn has a join timeout, and every collective the process group's
timeout, so a hang fails its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_workers as workers
from jax.sharding import Mesh

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.parallel import tempering as jpt
from isingmontecarlo_tpu.sse import diagonal as jdiag
from isingmontecarlo_tpu.sse import ising as jising
from isingmontecarlo_tpu.sse import model as jmodel
from isingmontecarlo_tpu.sse.opstring import OpString
from isingmontecarlo_tpu_torch.parallel import TemperingContainer, _dist, dryrun_sharded
from isingmontecarlo_tpu_torch.parallel import tempering as tpt
from isingmontecarlo_tpu_torch.sse import ising as tising
from isingmontecarlo_tpu_torch.sse import opstring as tops

from torch_port_utils import release_jax_executables  # noqa: F401  (autouse)

torch.set_num_threads(1)

WORLD, R, T = 4, 16, 4
DO_SWAP = [True, False, True, True]
RING = lattice.chain(4, j=1.0)
SPAWN_TIMEOUT = 240.0


def _string(h: float, xors: np.ndarray, beta: float, seed: int = 4, nsweeps: int = 12):
    """Numpy ``(bond, inputs, outputs, state)`` of the port's own chain on
    the ring, each replica under its sign pattern."""
    g = tising.QmcIsingGraph(RING, 1.0, h, replicas=R, seed=seed, device="cpu")
    x = torch.from_numpy(xors)
    for _ in range(nsweeps):
        g.sse, _ = tising.sweep(g.sse, beta, g.model, g.draws, bond_xor=x)
        g._maybe_grow()
    assert bool(tops.verify(g.sse.ops, g.sse.state, g.model, x).all())
    ops = g.sse.ops
    return tuple(a.numpy() for a in (ops.bond, ops.inputs, ops.outputs, g.sse.state))


def _case(kind: str) -> dict:
    """Global numpy inputs of one ladder kind on the ring (as
    ``tests/test_torch_tempering.py``'s chunk cases, at R=16)."""
    h = 0.4 if kind == "signed" else 0.0
    nb = 12 if h else 8
    xors = None
    if kind == "signed":
        xors = np.zeros((R, nb), np.int32)
        xors[1::2, 0] = 1  # one flipped edge at small beta: some swaps accept
    hetero = kind == "hetero_heatbath"
    arrays = _string(h, xors if xors is not None else np.zeros((R, nb), np.int32),
                     0.4 if xors is not None else 1.0)
    if hetero:
        betas = np.full(R, 1.0, np.float32)
    elif kind == "signed":
        betas = np.repeat(np.linspace(0.3, 0.5, R // 2), 2).astype(np.float32)
    else:
        betas = np.repeat(np.linspace(0.6, 1.4, R // 2), 2).astype(np.float32)
    scales = np.ones((R, nb), np.float32)
    if hetero:
        cls = np.asarray(jpt.tfim_bond_classes(4, 4, nb))
        per_class = np.stack([np.ones(R), np.linspace(0.5, 1.5, R), np.ones(R)], 1)
        scales = per_class[:, cls].astype(np.float32)
    jm = jmodel.tfim_model(RING, 1.0, h)
    case = dict(zip(("bond", "inputs", "outputs", "state"), arrays), betas=betas,
                scales=scales, xors=xors, heatbath=hetero, hetero=hetero, parity=1,
                do_swap=DO_SWAP, jax_model=jm,
                model={k: np.asarray(getattr(jm, k)) for k in workers.MODEL_LEAVES}
                | {"offset": jm.offset, "nvars": jm.nvars})
    if hetero:
        hb = jdiag.make_heatbath_tables(jm, jnp.asarray(scales))
        case["cum_max_w"], case["total"] = np.asarray(hb.cum_max_w), np.asarray(hb.total)
    return case


def _jax_draws(key, M: int, N: int) -> list:
    """Each rank's per-timestep draws of JAX's sharded chunk, as tensors."""
    R_l = R // WORLD
    S = M + N + 1  # cap-less sweeps label at full size

    def t_(x):
        return torch.from_numpy(np.array(x))

    draws = []
    for d in range(WORLD):
        steps = []
        for t in range(T):
            key_t = jax.random.fold_in(key, t)
            k_sweep = jax.random.fold_in(jax.random.fold_in(key_t, 0), d)
            _, k_diag, _, k_clust, k_free = jax.random.split(k_sweep, 5)
            steps.append({
                "diagonal": t_(jax.random.uniform(k_diag, (3, M, R_l))),
                "cluster": {(S, R_l): t_(jax.random.uniform(jax.random.fold_in(k_clust, 0),
                                                            (S, R_l)))},
                "free_spins": t_(jax.random.bernoulli(k_free, 0.5, (R_l, N))),
                "swap": t_(jax.random.uniform(jax.random.fold_in(key_t, 1), (R,))),
            })
        draws.append(steps)
    return draws


def _joined(outs: list, name: str):
    """The ranks' blocks of output ``name`` joined along its replica axis."""
    parts = [o[name] for o in outs]
    if parts[0] is None:
        return None
    dim = {"bond": 1, "inputs": 2, "outputs": 2, "ns": 1, "states": 1, "betas_t": 1}.get(name, 0)
    return torch.cat(parts, dim=dim).numpy()


GLOBAL = ("bond", "inputs", "outputs", "state", "betas", "scales", "xors", "cum_max_w",
          "total", "ns", "states", "betas_t")


def _assert_replicated(outs: list) -> None:
    for o in outs[1:]:
        assert (o["parity"], o["nswaps"]) == (outs[0]["parity"], outs[0]["nswaps"])
        assert torch.equal(o["fingerprint"], outs[0]["fingerprint"])
    fp = outs[0]["fingerprint"]
    assert torch.equal(fp, fp[:1].expand_as(fp)), fp


def test_sharded_chunk_matches_jax_sharded_chunk(tmp_path):
    devs = jax.devices()
    if len(devs) < WORLD:
        pytest.skip("needs the virtual CPU devices of tests/conftest.py")
    mesh = Mesh(np.array(devs[:WORLD]), axis_names=("replicas",))
    kinds = ("homogeneous", "hetero_heatbath", "signed")
    cases, want = [], []
    for i, kind in enumerate(kinds):
        case = _case(kind)
        key = jax.random.key(21 + i)
        sse = jising.SseState(ops=OpString(*(jnp.asarray(case[k]) for k in
                                              ("bond", "inputs", "outputs"))),
                              state=jnp.asarray(case["state"]), key=key)
        hb = (jdiag.HeatBathTables(cum_max_w=jnp.asarray(case["cum_max_w"]),
                                   total=jnp.asarray(case["total"]))
              if case["hetero"] else None)
        out = jpt.tempering_sweep_chunk_sharded(
            sse, jnp.asarray(case["betas"]), jnp.asarray(case["scales"]),
            jnp.int32(case["parity"]), jnp.asarray(DO_SWAP), case.pop("jax_model"), T,
            mesh=mesh, hb=hb, heatbath=case["heatbath"], hetero=case["hetero"],
            collect_states=True,
            xors=None if case["xors"] is None else jnp.asarray(case["xors"]))
        sse_j, betas, scales, xors, hb, parity, nswaps, ns, states, betas_t = out
        want.append({"bond": sse_j.ops.bond, "inputs": sse_j.ops.inputs,
                     "outputs": sse_j.ops.outputs, "state": sse_j.state, "betas": betas,
                     "scales": scales, "xors": xors,
                     "cum_max_w": None if hb is None else hb.cum_max_w,
                     "total": None if hb is None else hb.total, "parity": int(parity),
                     "nswaps": int(nswaps), "ns": ns, "states": states, "betas_t": betas_t})
        case["draws"] = _jax_draws(key, case["bond"].shape[0], 4)
        cases.append(case)
    got = _dist.spawn(workers.run_chunk_cases, WORLD, "gloo", cases, timeout=SPAWN_TIMEOUT,
                      workdir=str(tmp_path))
    for i, kind in enumerate(kinds):
        outs = [g[i] for g in got]
        _assert_replicated(outs)
        assert (outs[0]["parity"], outs[0]["nswaps"]) == (want[i]["parity"],
                                                          want[i]["nswaps"]), kind
        assert want[i]["nswaps"] > 0, f"{kind}: no swap was accepted: the case tests nothing"
        for name in GLOBAL:
            w = want[i][name]
            if w is None:
                assert _joined(outs, name) is None, (kind, name)
            else:
                np.testing.assert_array_equal(_joined(outs, name), np.asarray(w),
                                              err_msg=f"{kind}: {name}")


def _unsharded(case: dict, seed: int) -> dict:
    """The port's unsharded chunk on a generator seeded with ``seed``."""
    from isingmontecarlo_tpu_torch import convert

    sse = convert.sse_state_from_numpy(bond=case["bond"], inputs=case["inputs"],
                                       outputs=case["outputs"], state=case["state"],
                                       device="cpu")
    model = convert.model_from_numpy(**{k: case["model"][k] for k in workers.MODEL_LEAVES},
                                     offset=case["model"]["offset"],
                                     nvars=case["model"]["nvars"], device="cpu")
    gen = torch.Generator().manual_seed(seed)
    out = tpt.tempering_sweep_chunk(
        sse, torch.from_numpy(case["betas"]), torch.from_numpy(case["scales"]),
        case["parity"], DO_SWAP, model, T, lambda: tising.GeneratorDraws(gen),
        heatbath=False, hetero=case["hetero"], collect_states=True,
        xors=None if case["xors"] is None else torch.from_numpy(case["xors"]))
    sse, betas, scales, xors, _, parity, nswaps, ns, states, betas_t = out
    return {"bond": sse.ops.bond, "inputs": sse.ops.inputs, "outputs": sse.ops.outputs,
            "state": sse.state, "betas": betas, "scales": scales, "xors": xors,
            "cum_max_w": None, "total": None, "parity": int(parity), "nswaps": int(nswaps),
            "ns": ns, "states": states, "betas_t": betas_t}


def test_sharded_chunk_equals_unsharded_on_block_draws(tmp_path):
    """``BlockDraws`` give every rank its block of one unsharded run's
    uniforms: the sharded chunk is then the unsharded one (h = 0, no cluster
    caps), for a beta ladder and a signed ladder."""
    cases = []
    for i, kind in enumerate(("homogeneous", "signed")):
        case = _case(kind)
        case.pop("jax_model")
        if kind == "signed":  # h = 0: the ring's signed string without the field
            xors = np.zeros((R, 8), np.int32)
            xors[1::2, 0] = 1
            case.update(dict(zip(("bond", "inputs", "outputs", "state"),
                                 _string(0.0, xors, 0.4))), xors=xors,
                        scales=np.ones((R, 8), np.float32))
            jm = jmodel.tfim_model(RING, 1.0, 0.0)
            case["model"] = ({k: np.asarray(getattr(jm, k)) for k in workers.MODEL_LEAVES}
                             | {"offset": jm.offset, "nvars": jm.nvars})
        case.update(draws=None, seed=40 + i)
        cases.append(case)
    got = _dist.spawn(workers.run_chunk_cases, WORLD, "gloo", cases, timeout=SPAWN_TIMEOUT,
                      workdir=str(tmp_path))
    for i, case in enumerate(cases):
        outs = [g[i] for g in got]
        _assert_replicated(outs)
        want = _unsharded(case, case["seed"])
        assert (outs[0]["parity"], outs[0]["nswaps"]) == (want["parity"], want["nswaps"])
        assert want["nswaps"] > 0
        for name in GLOBAL:
            if want[name] is None:
                assert _joined(outs, name) is None, name
            else:
                np.testing.assert_array_equal(_joined(outs, name), want[name].numpy(),
                                              err_msg=name)


def test_sharded_container_oracles(tmp_path):
    res = _dist.spawn(workers.container_oracles, WORLD, "gloo", str(tmp_path),
                      timeout=SPAWN_TIMEOUT, workdir=str(tmp_path))
    first = res[0]
    for r in res[1:]:
        # Every rank took the same growth decisions and holds the same
        # global samples, labels and swap bookkeeping.
        assert r["grown"] == first["grown"]
        assert all(torch.equal(a, b) for a, b in zip(r["samples"], first["samples"]))
        assert all(torch.equal(a, b) for a, b in zip(r["by_temperature"],
                                                     first["by_temperature"]))
        np.testing.assert_array_equal(r["class_scales"], first["class_scales"])
        assert torch.equal(r["fingerprint"], first["fingerprint"])
        assert r["signed_swaps"] == first["signed_swaps"]
    assert first["grown"][2] is False, "the growth phase never ended"
    bonds = torch.cat([r["independent_bond"] for r in res], dim=1)  # [M, R], 4 a rank
    assert not torch.equal(bonds[:, 0], bonds[:, 4]), "ranks 0 and 1 drew one stream"
    assert not torch.equal(bonds[:, 0], bonds[:, 1]), "two lanes of a rank drew one stream"


def test_shard_over_refuses_without_a_process_group():
    tc = TemperingContainer(RING, 1.0, betas=[0.5, 1.0], seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tc.shard_over()
    assert tc._shard is None and tc.graph.replicas == 2


def test_dryrun_sharded_on_gloo_ranks():
    res = dryrun_sharded(2, "gloo", "cpu", timeout=SPAWN_TIMEOUT)
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        assert r["verify"] and r["device"] == "cpu" and r["replicas"] == 4
        assert (r["n"], r["betas"], r["swaps"]) == (res[0]["n"], res[0]["betas"],
                                                   res[0]["swaps"])
    assert sorted(res[0]["betas"]) == pytest.approx(np.linspace(0.5, 2.0, 4).tolist())
    # Each of the two swaps gathered n, betas, the [R_l, NB] scales and bond
    # counts, and the heat-bath rows and totals, of 2 replicas a rank.
    for r in res:
        assert r["traffic"]["swap"]["calls"] == 12
        assert r["traffic"]["swap"]["shapes"] == [((2,), "float32"), ((2,), "int32"),
                                                  ((2, 48), "float32"), ((2, 48), "int32")]

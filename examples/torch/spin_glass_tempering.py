"""2D +-J spin glass, 64 replicas, parallel tempering on the PyTorch port
(``examples/spin_glass_tempering.py``): replica exchange on the card, and
sharded over the ranks when launched by ``torchrun``.

Run: python examples/torch/spin_glass_tempering.py [--device cuda|cpu]
     torchrun --nproc-per-node=N examples/torch/spin_glass_tempering.py
         [--device cuda|cpu] [--backend nccl|gloo]

Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank builds the same ladder
and keeps its block of the replicas (``TemperingContainer.shard_over``):
rank k runs on card ``LOCAL_RANK`` modulo the card count (``nccl`` needs a
card a rank; ``gloo`` ranks may share one), or on the CPU with
``--device cpu``. Rank 0 prints.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from isingmontecarlo_tpu_torch import TemperingContainer, lattice  # noqa: E402

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
parser.add_argument("--backend", default=None,
                    help="nccl on cards, gloo on the CPU unless given")
args = parser.parse_args()

dev = torch.device(args.device)
world = int(os.environ.get("WORLD_SIZE", "1"))
rank = 0
if world > 1:
    backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend)  # torchrun passes the rendezvous
    rank = dist.get_rank()

L = 8
rng = np.random.RandomState(0)
# One +-J disorder realization, the same on every rank.
edges = [((a, b), float(rng.choice([-1.0, 1.0]))) for (a, b), _ in lattice.square(L, L)]

betas = np.geomspace(0.2, 3.0, 16)
tc = TemperingContainer(edges, transverse=1.0, betas=betas, replicas_per_beta=4, seed=7,
                        device=dev)  # 64 replicas
if world > 1:
    tc.shard_over()
    if rank == 0:
        print(f"sharded over {world} ranks ({dist.get_backend()}), "
              f"{tc.graph.replicas} replicas a rank")

tc.timesteps(50)  # equilibrate
states, bet = tc.timesteps_sample(100, swap_freq=2, sampling_freq=10)
ordered, b_sorted = tc.states_by_temperature()
ok = tc.verify()
if rank == 0:
    print("device:", dev)
    print("samples:", tuple(states.shape), "swaps:", tc.total_swaps)
    m = (2.0 * ordered.double() - 1.0).mean(dim=1).abs()
    print("|m| of the coldest 4:", np.round(m[-4:].cpu().numpy(), 3))
    print("verify:", ok)
    print("beta ladder:", np.round(b_sorted[:8].cpu().numpy(), 2), "...")
if world > 1:
    dist.destroy_process_group()

"""The reference's six examples on the port, one module each; each mirrors
the same-named ``examples/*.py`` of the repository and prints its lines in
its format:

* :mod:`.quickstart` — the dynamic scheduler against the static one on a
  simulated hybrid CPU, then reduced granite-8b trained for 30 steps;
* :mod:`.q4_inference` — Q4_0 weights through the CUDA Q4 kernel against
  the float model, and the kernel tuner over the kernel's launch variants;
* :mod:`.hybrid_cpu_inference` — the paper's llama2-7B scenario on two
  simulated hybrid CPUs and its Fig. 4 ratio trace (virtual clock only);
* :mod:`.serve_batch` — whole-batch routing over two replicas by measured
  throughput (paper Eq. 3);
* :mod:`.continuous_serving` — continuous batching with phase-aware
  replica routing under Poisson traffic;
* :mod:`.train_100m` — llama-100m (56M parameters) trained with
  checkpoint/restart and the uneven-DP step.

Run one as ``python -m repro_torch.examples.<name>``: on the card by
default, ``--device cpu`` for the plain PyTorch path.  Each takes its
weights from a seeded :class:`torch.Generator` on the CPU and moves them to
the device (:func:`seeded_params`), so a card run and a CPU run start
from the same weights.
"""

import torch

from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.tree import tree_map

__all__ = ["seeded_params"]


def seeded_params(cfg, device, params=None) -> dict:
    """``params`` on ``device``; without them the model's weights drawn from
    seed 0 on the CPU, so every device gets the same ones."""
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    device = resolve_device(device)
    return tree_map(lambda t: t.to(device), params)

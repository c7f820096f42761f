"""Step telemetry: the gradient, update and parameter norms of a train
step, computed on the device inside the step (`--telemetry`).

Port of ref real_time_helmet_detection_tpu/obs/telemetry.py:45-58
`telemetry_scalars` (`optax.global_norm` of the gradients, of new - old
parameters and of the new parameters). The norms are 0-d float32 device
tensors from the foreach norms (one kernel per list, no host read); the
train step puts them into its losses dict, so they ride the one copy
that fetches the losses every `--print-interval` steps.

Not ported: the scanned path's telemetry ring (it belongs to a scanned
benchmark loop the port does not have yet) and the recompile counter
(nothing in the eager port compiles).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

NORM_KEYS = ("grad_norm", "update_norm", "param_norm")


@torch.no_grad()
def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors, as a 0-d float32
    tensor (0 for an empty list); no autograd graph."""
    tensors = [t.detach() for t in tensors if t is not None]
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm([t.float() if t.dtype != torch.float32
                                 else t for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def telemetry_scalars(grads: Sequence[torch.Tensor],
                      old_params: Sequence[torch.Tensor],
                      new_params: Sequence[torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """{"grad_norm", "update_norm", "param_norm"} of one step."""
    update = torch._foreach_sub([p.detach().float() for p in new_params],
                                [p.detach().float() for p in old_params])
    return {"grad_norm": global_norm(grads),
            "update_norm": global_norm(update),
            "param_norm": global_norm(new_params)}

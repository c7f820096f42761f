"""Process groups of the port's data parallelism: one process per card.

Port of ref real_time_helmet_detection_tpu/parallel/distributed.py:65
`init_process_group`, :105 `coordination_barrier` and :139
`barrier_synced_compile` onto `torch.distributed` (the reference's
`mp.spawn` + NCCL + DDP, reference train.py:23-45):

* `init_process_group(cfg, device)` is idempotent and does nothing at
  world 1. Rank 0 hosts a `TCPStore` at `--dist-url`; the process group
  (NCCL for a card, gloo for the CPU, or `--dist-backend` by name) is
  built on that store, which also carries the barriers.
* `coordination_barrier(name, timeout_s)`: every rank meets at a store
  key. When a rank never arrives, the others raise a RuntimeError that
  starts with `DEADLINE_EXCEEDED:` and names the barrier, as JAX's does,
  so a supervisor reads it as transient.
* `barrier_synced_build(device)`, the port's form of JAX's barrier law
  (build, then barrier, then the first collective): nvcc at first use can
  skew the ranks by minutes, longer than a collective waits. Rank 0
  builds and loads the kernel libraries, every rank meets, then the
  others load the cached libraries. A duplicate build stays correct:
  each library lands under its name by `os.replace`.
* `world_size()` and `all_reduce_sum_(t)`: the global-batch hooks of the
  BN passes and the loss (JAX's GSPMD step reduces over the global batch)
  call these; at world 1 they run no collective. `all_gather_arrays`
  gathers multi-process eval's fixed-shape detection blocks.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# JAX's default barrier timeout (ref parallel/distributed.py:48)
DEFAULT_TIMEOUT_S = 15 * 60.0

_store: Optional[dist.TCPStore] = None
_generation: dict = {}  # barrier name -> uses so far in this process


def world_size() -> int:
    """Ranks of the active process group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over every rank in place (a no-op at world 1); returns t."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


def all_gather_arrays(arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Each array (one shape on every rank) stacked over the ranks:
    (world, ...) in rank order (ref evaluate.py:414 `process_allgather`).
    NCCL gathers through the current card, gloo on the host."""
    dev = torch.device("cpu")
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        parts = [torch.empty_like(t) for _ in range(world_size())]
        dist.all_gather(parts, t)
        out.append(torch.stack(parts))
    return [t.cpu().numpy() for t in out]  # the gathers queued first


def backend_for(cfg, device) -> str:
    """`--dist-backend`: "xla" (JAX's default) names the device's own
    backend, NCCL for a card and gloo for the CPU."""
    if cfg.dist_backend != "xla":
        return cfg.dist_backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _host_port(url: str):
    if not url.startswith("tcp://"):
        raise ValueError("--dist-url must be tcp://host:port, got %r" % url)
    host, _, port = url[len("tcp://"):].rpartition(":")
    return host or "localhost", int(port)


def init_process_group(cfg, device="cpu",
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the `cfg.world_size` ranks at `cfg.dist_url` (≡ reference
    `dist.init_process_group`, reference train.py:42-45). Returns True
    when this call made the group; at world 1, or when a group exists,
    does nothing and returns False."""
    global _store
    if cfg.world_size <= 1 or dist.is_initialized():
        return False
    host, port = _host_port(cfg.dist_url)
    timeout = datetime.timedelta(seconds=timeout_s)
    _store = dist.TCPStore(host, port, cfg.world_size,
                           is_master=cfg.rank == 0, timeout=timeout)
    dist.init_process_group(backend_for(cfg, device), store=_store,
                            world_size=cfg.world_size, rank=cfg.rank,
                            timeout=timeout)
    return True


def destroy_process_group() -> None:
    """Leave the process group made by `init_process_group`, if any."""
    global _store
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _store = None
    _generation.clear()


def coordination_barrier(name: str,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Wait until every rank has reached the barrier `name` (each use of
    a name is a barrier of its own). A no-op at world 1."""
    if world_size() <= 1 or _store is None:
        return
    use = _generation.get(name, 0)
    _generation[name] = use + 1
    key = "helmet/barrier/%s/%d" % (name, use)
    try:
        if _store.add(key + "/arrived", 1) == world_size():
            _store.set(key + "/open", b"1")
        _store.wait([key + "/open"], datetime.timedelta(seconds=timeout_s))
    except Exception as e:  # noqa: BLE001 — a timeout or a lost store
        raise RuntimeError(
            "DEADLINE_EXCEEDED: coordination barrier %r did not clear in "
            "%.0fs: a rank died or wedged before arriving (%s). Restart "
            "the whole multi-process job rather than wait on a half-dead "
            "rendezvous." % (name, timeout_s,
                             str(e).splitlines()[0][:200] if str(e)
                             else type(e).__name__)) from e


def barrier_synced_build(device,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Build the kernel libraries before the first collective: rank 0
    builds and loads them, every rank meets at a barrier, then the other
    ranks load the cached libraries. On the CPU (the plain versions run)
    nothing is built."""
    if torch.device(device).type != "cuda":
        return
    from ..ops import _build

    def build_and_load():
        for name in _build.build():
            _build.load(name)

    if rank() == 0:
        build_and_load()
    coordination_barrier("kernels-built", timeout_s)
    if rank() != 0:
        build_and_load()

"""Data parallelism: one process per device over ``torch.distributed``.

Port of ``fusiontransformer_tpu/parallel/data_parallel.py``.  The JAX
package runs one program over a device mesh under ``shard_map``; here each
process holds a whole replica of the model on its own device and trains on
its own share of the batch, as the reference's DDP did, and the
collectives of ``torch.distributed`` (NCCL between cards, gloo on the CPU)
carry what ``lax.pmean`` / ``lax.psum`` carry in the JAX step
(``modules/steps.py``):

* the gradients, averaged before the optimizer update;
* the BatchNorm running buffers, averaged after each step (each rank
  normalises its shard with the shard's own batch statistics, as each JAX
  device does: this is not ``SyncBatchNorm``);
* the step's metrics: losses and overflow counts averaged, the confusion
  matrices ``cm_*`` summed.

Each group of tensors goes in one coalesced ``all_reduce`` (``Reducer``).
The collectives run eagerly, outside the trainer's CUDA graphs.  Scans are
whole on one rank: ``shard_of`` cuts a collated batch into contiguous runs
of scans and re-bases their scan ids (``localize_scan_ids``), so that the
image lift gathers from the rank's own images.  Dropout draws from a
generator per rank (``rank_seed``), where JAX folds the device's index into
one key.

``init_distributed`` joins the process group that ``torch.distributed.run``
(torchrun) describes in the environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or finds one the caller
made; the backend is NCCL for a CUDA device and gloo for the CPU unless the
caller names one.  A collective that fails raises, and the process exits
non-zero.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

# Per-point arrays of a collated batch, cut by rows; per-scan arrays and
# lists are cut by scans.
POINT_KEYS = ("coords", "feats", "seg_label", "pt_batch", "pt_valid",
              "img_indices")
SCAN_KEYS = ("img", "scan_count", "level_counts_per_scan",
             "orig_seg_label", "sparse_orig_points_idx", "inverse_map",
             "seq", "filename")


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device, backend=None):
    """Join the default process group and return ``(rank, world_size)``.

    A group that is already initialised (the caller's, e.g. over a
    ``FileStore``) is used as it is, and must have ``backend`` when one is
    named.  Otherwise the group is made from torchrun's environment with
    ``backend``, or the default backend of ``device``.  Nothing switches
    backend or device quietly."""
    if dist.is_initialized():
        have = dist.get_backend()
        if backend is not None and have != backend:
            raise ValueError(f"the process group runs {have}, not the "
                             f"requested {backend}")
    else:
        dist.init_process_group(backend or default_backend(device),
                                init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def rank_seed(seed: int, rank: int) -> int:
    """The dropout generator's seed of rank ``rank``: ``seed`` itself on
    rank 0 (a one-rank run draws what the single-device trainer draws),
    one stream per rank past it."""
    return int(seed) + rank * 1_000_003


def localize_scan_ids(batch, scans_per_device: int):
    """``batch`` with its scan ids re-based to the shard, ``pt_batch %
    scans_per_device`` (the JAX package's ``_localize_scan_ids``)."""
    out = dict(batch)
    out["pt_batch"] = np.asarray(batch["pt_batch"]) % scans_per_device
    return out


def shard_of(batch, rank: int, world_size: int):
    """Rank ``rank``'s share of a collated host batch: its contiguous run of
    whole scans (the JAX mesh's ``P("data")`` layout of the leading axis),
    scan ids re-based.  The batch's totals (``level_counts``,
    ``num_dropped``) are those of the shard.  A batch with group-pooled
    slot maps cannot be cut: they are pooled over the whole batch."""
    if any(k.startswith("gslot_") for k in batch):
        raise ValueError("a batch with group-pooled slot maps (gslot_*) "
                         "cannot be sharded; data parallelism runs the "
                         "per-voxel maps")
    n_scans = len(batch["scan_count"])
    if n_scans % world_size:
        raise ValueError(f"{n_scans} scans do not divide over "
                         f"{world_size} ranks")
    per = n_scans // world_size
    cap = len(batch["pt_valid"]) // n_scans
    rows = slice(rank * per * cap, (rank + 1) * per * cap)
    scans = slice(rank * per, (rank + 1) * per)
    out = dict(batch)
    for k in POINT_KEYS:
        if k in batch:
            out[k] = batch[k][rows]
    for k in SCAN_KEYS:
        if k in batch:
            out[k] = batch[k][scans]
    if "level_counts_per_scan" in batch:
        out["level_counts"] = np.asarray(
            out["level_counts_per_scan"]).sum(0)
    if "num_dropped" in batch:
        out["num_dropped"] = 0     # the collate counts the whole batch
    return localize_scan_ids(out, per)


def repad(batch, cap: int, target: int):
    """``batch`` (``cap`` rows a scan) with each scan's rows padded to
    ``target``: the capacity bucket every rank agreed on (the JAX package's
    ``_sync_bucket_capacity``)."""
    if target == cap:
        return batch
    b = len(batch["scan_count"])
    out = dict(batch)
    for k in POINT_KEYS:
        if k in batch:
            v = np.asarray(batch[k]).reshape(b, cap, *np.shape(batch[k])[1:])
            pad = [(0, 0), (0, target - cap)] + [(0, 0)] * (v.ndim - 2)
            out[k] = np.pad(v, pad).reshape(b * target, *v.shape[2:])
    return out


class Reducer:
    """The collectives of a data-parallel step over ``group`` (None: the
    default group; under tensor parallelism the data group): every call is
    one collective (tensors of one dtype coalesced into one buffer), run by
    every rank of the group in the same order.  ``device`` is where the
    group's integer tensors live: the card for NCCL, the CPU for gloo."""

    def __init__(self, device, group=None):
        self.group = group
        self.world_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        # The global rank of the group's rank 0 (a broadcast's source).
        self.root = 0 if group is None else dist.get_global_rank(group, 0)
        self.comm_device = torch.device(device) \
            if self.backend == "nccl" else torch.device("cpu")

    def _coalesced(self, tensors, op):
        """``op(flat)`` on each dtype's tensors flattened into one buffer,
        written back in place."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            op(flat)
            for t, v in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(v.view_as(t))

    def mean_(self, tensors):
        """Average ``tensors`` over the ranks, in place (``lax.pmean``)."""
        def op(flat):
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.world_size)
        with torch.no_grad():
            self._coalesced(list(tensors), op)

    def broadcast_(self, tensors):
        """The group's rank 0's values of ``tensors`` on every rank of the
        group, in place."""
        with torch.no_grad():
            self._coalesced(list(tensors), lambda f: dist.broadcast(
                f, self.root, group=self.group))

    def metrics(self, metrics):
        """A train step's metrics reduced over the ranks, as new tensors:
        ``cm_*`` summed (``lax.psum``), every other one averaged into f32
        (``lax.pmean``).  One all-reduce in f64, exact for the counts."""
        keys = list(metrics)
        flat = torch.cat([metrics[k].reshape(-1).to(torch.float64)
                          for k in keys])
        dist.all_reduce(flat, group=self.group)
        out, at = {}, 0
        for k in keys:
            v = metrics[k]
            part = flat[at:at + v.numel()].view(v.shape)
            at += v.numel()
            out[k] = part.to(v.dtype) if k.startswith("cm_") \
                else (part / self.world_size).to(torch.float32)
        return out

    def all_gather_ints(self, values):
        """Every rank's ``values`` (a short list of ints): ``[world, n]``."""
        mine = torch.as_tensor(np.asarray(values, np.int64),
                               device=self.comm_device)
        parts = [torch.empty_like(mine) for _ in range(self.world_size)]
        dist.all_gather(parts, mine, group=self.group)
        return torch.stack(parts).cpu().numpy()

    def sum_array(self, array):
        """A host array summed over the ranks (the validation's confusion
        matrices; f64, exact for counts below 2**53)."""
        t = torch.as_tensor(np.asarray(array, np.float64),
                            device=self.comm_device)
        dist.all_reduce(t, group=self.group)
        return t.cpu().numpy().astype(np.asarray(array).dtype)

    def gather_objects(self, obj):
        """Every rank's ``obj`` (picklable), in rank order."""
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self):
        dist.barrier(group=self.group)

"""Train and eval steps, capacity rules and hierarchy construction (torch).

Port of ``fusiontransformer_tpu/modules/steps.py``:

* ``level_caps_for_n`` sizes the voxel levels from the batch's point buffer,
  ``adaptive_level_caps`` from the batch's exact per-level voxel counts up
  the capacity ladder (``TPU.ADAPTIVE_LEVEL_CAPS``); the host slot maps use
  the same rules (``ops/host_slots.py``);
* ``hier_from_cfg`` builds the hierarchy with conv slot maps: the batch's
  group-pooled maps when it carries them (``TPU.CONV_SLOT_POOL``), else
  per-voxel K-slot maps built on the device (``TPU.CONV_TAP_SLOTS``);
  ``device_batch`` moves the array part of a collated batch to the device;
* ``make_train_step``: forward in train mode, CE + lambda * KL per stream,
  the two streams summed (one stream's CE for the uni-modal models, which
  build no hierarchy without the 3D stream), one backward into the
  parameters' static ``.grad``, the frozen-pattern mask, the optimizer
  step (every ``TRAIN.GRAD_ACCUM_STEPS``-th call, on the mean of the
  accumulated gradients); returns the losses, ``voxel_overflow`` (and
  ``tap_overflow`` with per-voxel maps) and the confusion matrices.  Image
  features are detached before fusion and the KL teachers are detached, so
  the gradient of the summed loss equals the reference's two accumulated
  backward passes (as in the JAX step).  Its parts run in
  ``record_function`` ranges (``train_step.forward`` / ``.backward`` /
  ``.optimizer`` / ``.metrics``), which a ``torch.profiler`` trace shows;
* ``make_eval_step``: per-point predictions of each present stream and,
  for a fusion model, of the sum of the 2D and 3D softmaxes, with the
  per-stream CE.

* ``StepGraph``: a step captured in one CUDA graph at one input signature
  (``batch_signature``), the role ``jax.jit`` plays in the JAX package;
  ``StepCache``: the LRU cache of them (``TPU.STEP_CACHE_SIZE``).  The
  inference engine keeps its predict step's graphs in one, the trainer its
  train and eval steps' graphs in two, as the JAX package keeps one compiled
  program per input shape.  ``Readback`` carries a step's output to pinned
  host memory in stream order.
"""

from __future__ import annotations

import re
import time
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from fusiontransformer_tpu_torch.models.losses import (kl_divergence,
                                                       weighted_cross_entropy)
from fusiontransformer_tpu_torch.models.metric import \
    confusion_matrix_from_logits
from fusiontransformer_tpu_torch.ops.hierarchy import (attach_grouped_slots,
                                                       build_hierarchy)
from fusiontransformer_tpu_torch.ops.host_slots import (adaptive_caps,
                                                        caps_from_fractions)
from fusiontransformer_tpu_torch.utils.convert_jax import jax_leaf_path


def level_caps_for_n(cfg, n_total: int):
    """Voxel capacities per level for a batch whose point buffer holds
    ``n_total`` rows (L0 a fraction of the buffer, L1+ chained fractions,
    all 128-multiples; the host slot maps use the same rule)."""
    return caps_from_fractions(n_total, cfg.TPU.L0_CAPACITY_FRACTION,
                               cfg.TPU.LEVEL_CAPACITY_FRACTIONS)


def adaptive_level_caps(cfg, n_total: int, level_counts):
    """The batch's exact per-level voxel counts rounded up the ladder, with
    ``level_caps_for_n`` as the ceiling (the rule ``SlotPoolSpec`` applies
    with ``adaptive``)."""
    return adaptive_caps(level_caps_for_n(cfg, n_total), level_counts)


def batch_level_caps(cfg, host_batch):
    """The capacities a step builds its hierarchy with for ``host_batch``:
    adaptive when the batch carries ``level_counts``, else from its buffer."""
    n = len(host_batch["pt_valid"])
    if "level_counts" in host_batch:
        return adaptive_level_caps(cfg, n, host_batch["level_counts"])
    return level_caps_for_n(cfg, n)


def norm_tap_slots(cfg, num_levels: int):
    """``TPU.CONV_TAP_SLOTS`` normalised to the hierarchy depth: levels past
    the tuple get 0 (dense), extra entries are dropped; () when every entry
    is 0."""
    ts = tuple(cfg.TPU.CONV_TAP_SLOTS)
    if not any(ts):
        return ()
    return (ts + (0,) * num_levels)[:num_levels]


def per_voxel_slots(cfg, batch, num_levels: int):
    """The K per level of the device-built per-voxel K-slot maps the step
    uses for ``batch``: ``norm_tap_slots``, or () when the batch carries
    host-built group-pooled maps (``TPU.CONV_SLOT_POOL``)."""
    if "gslot_src_0" in batch:
        return ()
    return norm_tap_slots(cfg, num_levels)


def hier_from_cfg(cfg, batch, level_caps=None):
    """Hierarchy at ``level_caps`` (by default sized from the batch's point
    buffer) with conv slot maps: the batch's group-pooled maps
    (``gslot_src_{l}`` / ``gslot_bin_{l}``) when it carries them, else
    per-voxel K-slot maps built on the device at the levels
    ``TPU.CONV_TAP_SLOTS`` names (the JAX package's ``_hier_from_cfg``).
    Levels without maps run the dense ks3 path."""
    caps = level_caps or level_caps_for_n(cfg, batch["coords"].shape[0])
    hier = build_hierarchy(batch["coords"], batch["pt_batch"],
                           batch["pt_valid"], caps,
                           tap_slots=per_voxel_slots(cfg, batch, len(caps)))
    return attach_grouped_slots(hier, batch)


def tap_overflow(hier, tap_slots):
    """Live ks3 taps the per-voxel K-slot maps dropped (0: lossless)."""
    total = 0
    for lvl, k in zip(hier.levels, tap_slots):
        if k:
            live = (lvl.nbr_idx < lvl.valid.shape[0]).sum(1, dtype=torch.int32)
            total = total + (live - k).clamp(min=0).sum()
    return total


def overflow_metrics(cfg, batch, hier):
    """``voxel_overflow`` (voxels the level capacities dropped) and, where
    the step built per-voxel maps, ``tap_overflow``, as device tensors."""
    out = {"voxel_overflow": sum(
        (l.nvalid_raw - l.valid.shape[0]).clamp(min=0) for l in hier.levels)}
    ts = per_voxel_slots(cfg, batch, len(hier.levels))
    if ts:
        out["tap_overflow"] = tap_overflow(hier, ts)
    return out


_ARRAY_KEYS = ("coords", "feats", "seg_label", "pt_batch", "pt_valid", "img",
               "img_indices")


def device_arrays(batch):
    """The arrays of a collated batch that a step reads, by name (host lists
    stripped; group-pooled slot maps ride along)."""
    return {k: v for k, v in batch.items()
            if k in _ARRAY_KEYS or k.startswith(("gslot_src_", "gslot_bin_"))}


def host_tensor(array, device):
    """A host array as a tensor to copy to ``device``: pinned for the card,
    so the copy is asynchronous (the caching host allocator holds the
    staging buffer until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    return t.pin_memory() if torch.device(device).type == "cuda" else t


def device_batch(batch, device):
    """``device_arrays`` of a collated batch on ``device``."""
    return {k: host_tensor(v, device).to(device, non_blocking=True)
            for k, v in device_arrays(batch).items()}


def batch_signature(batch):
    """The input signature of a step over ``batch``: (name, shape, dtype) of
    every array ``device_batch`` hands it, which fixes the capacity bucket,
    the batch size and the pool size S of each ``gslot_*`` level."""
    return tuple((k, tuple(v.shape), np.dtype(v.dtype).str)
                 for k, v in sorted(device_arrays(batch).items()))


class StepCache:
    """LRU cache of captured steps by signature (``TPU.STEP_CACHE_SIZE``),
    the port of ``fusiontransformer_tpu/modules/steps.py::StepCache``.

    Each entry holds a captured graph with its static inputs and output;
    the group-pooled maps' pool-size ladder mints new signatures over a long
    run, so the cache is bounded.  Setting an entry refreshes its recency,
    as ``get`` does; past ``maxsize`` the least recently used goes.
    ``maxsize <= 0`` never evicts.
    """

    def __init__(self, maxsize=16):
        self.maxsize = int(maxsize)
        self._d = OrderedDict()

    def get(self, key):
        fn = self._d.get(key)
        if fn is not None:
            self._d.move_to_end(key)
        return fn

    def __setitem__(self, key, fn):
        self._d[key] = fn
        self._d.move_to_end(key)
        if self.maxsize > 0:
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)

    def __iter__(self):
        return iter(self._d)

    def clear(self):
        self._d.clear()


class Readback(NamedTuple):
    """A step's output on its way to the host: ``host`` (a tensor or a dict
    of tensors, pinned and the caller's own on the card) holds it once
    ``done`` has passed (no event on the CPU, where it is the output
    itself)."""
    host: object
    done: Optional["torch.cuda.Event"]
    graph: object           # kept alive until the copy has run

    def numpy(self):
        if self.done is not None:
            self.done.synchronize()
        if isinstance(self.host, dict):
            return {k: v.numpy() for k, v in self.host.items()}
        return self.host.numpy()


def read_back(out, graph=None) -> Readback:
    """Copy ``out`` (a device tensor or a dict of them) into pinned host
    memory of its own, in stream order: the copy runs before anything
    enqueued after it, such as the next replay, which overwrites a graph's
    static output."""
    one = torch.is_tensor(out)
    tensors = {"": out} if one else out
    if all(t.device.type == "cpu" for t in tensors.values()):
        return Readback(out, None, graph)
    host = {}
    for k, t in tensors.items():
        host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host[k].copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return Readback(host[""] if one else host, done, graph)


def _close_failed_capture(device, pool, stream, generator=None):
    """Undo what a capture that raised leaves behind in ``torch.cuda.graph``:
    its exit stops at the failed end of the capture, so the capture stream
    stays current and the allocator keeps routing that stream's allocations
    to ``pool``; and a generator registered with the graph stays in its
    capturing state, in which every later draw outside a capture raises (a
    capture that ends, an empty one with the generator registered, puts it
    back).  The pool itself stays unfit for another capture on the card's
    PyTorch (2.11: "beginAllocateToPool: already recording"), so the
    graph's owner takes a new pool for the next one."""
    torch.cuda.set_stream(stream)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(index, pool)
    except RuntimeError:
        pass        # the capture ended its allocation before it failed
    if generator is not None:
        reset = torch.cuda.CUDAGraph()
        reset.register_generator_state(generator)
        with torch.cuda.graph(reset):
            pass


class StepGraph:
    """``step(inputs)`` captured in one CUDA graph at one input signature.

    ``inputs`` are the graph's static input tensors (allocated outside the
    graph's memory pool), ``out`` its static output.  The step first runs
    eagerly on a side stream, on the batch the graph is made for (that run
    builds the kernels, warms cuBLAS and creates an optimizer's state); its
    output is ``first``.  For a train step that run is the batch's own
    step: a capture executes nothing, so the batch is not applied twice, and
    only later batches replay.  Then the step is captured with the memory
    ``pool`` that all of its owner's graphs share: they replay one at a
    time on one stream, and each replay's output is read back before the
    next one is enqueued.  ``generator``, where the step draws random
    numbers from one (dropout), is registered with the graph, so that each
    replay advances it and draws fresh numbers.  A capture that fails
    raises (``_close_failed_capture``); its owner then captures the next
    graph into a new pool.
    """

    def __init__(self, step, batch, device, pool, generator=None):
        self.inputs = {k: torch.empty(v.shape, device=device,
                                      dtype=torch.from_numpy(v[:0]).dtype)
                       for k, v in device_arrays(batch).items()}
        t0 = time.perf_counter()
        self.load(batch)
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.first = step(self.inputs)
        stream.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        try:
            # Only this thread's calls are checked against the capture: a
            # server's or a loader's other threads never touch its stream.
            # The backward's kernels, launched from autograd's device
            # thread, run on the forward's stream and so are captured too.
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.out = step(self.inputs)
        except BaseException:
            _close_failed_capture(device, pool, stream, generator)
            raise
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def load(self, batch):
        """Copy a host batch into the static inputs, stream-ordered, from
        pinned staging buffers."""
        for k, dst in self.inputs.items():
            dst.copy_(host_tensor(batch[k], dst.device), non_blocking=True)

    def replay(self, batch) -> Readback:
        self.load(batch)
        self.graph.replay()
        return read_back(self.out, self)


def frozen_params(model, patterns):
    """Parameters whose JAX leaf path matches any of ``patterns``
    (TRAIN.FROZEN_PATTERNS, regexes searched in the path)."""
    regexes = [re.compile(p) for p in patterns]
    return [p for n, p in model.named_parameters()
            if any(r.search("/".join(jax_leaf_path(n))) for r in regexes)]


def class_weights_of(cfg, device):
    if not cfg.TRAIN.CLASS_WEIGHTS:
        return None
    return torch.tensor(cfg.TRAIN.CLASS_WEIGHTS, dtype=torch.float32,
                        device=device)


def losses(cfg, out, batch, class_weights):
    """``(total, parts)``: the JAX ``_losses``.  A fusion model's loss is CE
    + lambda * KL per stream, summed over the two streams; a lidar-only
    model's the 3D CE (``seg_loss_3d``), an image-only model's the 2D CE
    (``seg_loss_2d``)."""
    valid, label = batch["pt_valid"], batch["seg_label"]
    m = cfg.MODEL
    if not m.USE_FUSION:
        key, logit = (("seg_loss_3d", "lidar_seg_logit") if m.USE_LIDAR
                      else ("seg_loss_2d", "img_seg_logit"))
        loss = weighted_cross_entropy(out[logit], label, valid, class_weights)
        return loss, {key: loss}
    lam = cfg.TRAIN.FusionTransformer.lambda_xm
    loss_3d = weighted_cross_entropy(out["lidar_seg_logit"], label, valid,
                                     class_weights)
    loss_2d = weighted_cross_entropy(out["img_seg_logit"], label, valid,
                                     class_weights)
    parts = {"seg_loss_3d": loss_3d, "seg_loss_2d": loss_2d}
    if lam > 0:
        dual = m.DUAL_HEAD
        logit_2d = out["img_seg_logit2" if dual else "img_seg_logit"]
        logit_3d = out["lidar_seg_logit2" if dual else "lidar_seg_logit"]
        xm_2d = kl_divergence(logit_2d, out["lidar_seg_logit"], valid)
        xm_3d = kl_divergence(logit_3d, out["img_seg_logit"], valid)
        parts["xm_loss_2d"] = xm_2d
        parts["xm_loss_3d"] = xm_3d
        loss_2d = loss_2d + lam * xm_2d
        loss_3d = loss_3d + lam * xm_3d
    return loss_2d + loss_3d, parts


def confusions(cfg, out, batch):
    """Confusion matrices of the present streams: ``cm_3d`` with the 3D
    stream, ``cm_2d`` with the image stream (the JAX ``_confusions``)."""
    n = cfg.MODEL.NUM_CLASSES
    valid, label = batch["pt_valid"], batch["seg_label"]
    cms = {}
    if cfg.MODEL.USE_LIDAR:
        cms["cm_3d"] = confusion_matrix_from_logits(out["lidar_seg_logit"],
                                                    label, valid, n)
    if cfg.MODEL.USE_IMAGE:
        cms["cm_2d"] = confusion_matrix_from_logits(out["img_seg_logit"],
                                                    label, valid, n)
    return cms


def step_hier(cfg, batch, level_caps=None):
    """The hierarchy a step builds for ``batch``: ``hier_from_cfg`` for a
    model with the 3D stream, None for an image-only model."""
    return hier_from_cfg(cfg, batch, level_caps) if cfg.MODEL.USE_LIDAR \
        else None


class TrainStep:
    """The train step of ``make_train_step``.

    ``step(batch, generator, level_caps=None, update=True) -> metrics``:
    ``batch`` a ``device_batch``; ``generator`` the ``torch.Generator`` (on
    the batch's device) that dropout draws from.  The metrics are device
    tensors: the losses, ``total_loss``, with the 3D stream
    ``voxel_overflow`` and ``tap_overflow`` where the step built per-voxel
    slot maps, and the present streams' confusion matrices ``cm_2d`` /
    ``cm_3d``.

    The gradients are static: each parameter's ``.grad`` is allocated once,
    here, outside any CUDA graph, and the backward adds into it, so every
    graph of the step reads and writes the same tensors (and no graph's
    pool holds a copy of them).  A parameter the loss does not reach (the
    middle-fusion image taps feed only the detached fusion input) keeps a
    zero gradient, as jax.grad gives it, so the optimizer still applies its
    weight decay and moment updates.  ``update()`` (run by the step unless
    ``update=False``) zeroes the frozen parameters' gradients, divides the
    sum by ``TRAIN.GRAD_ACCUM_STEPS`` = k, steps the optimizer and zeroes
    the gradients.  With k > 1 the trainer runs the step with
    ``update=False`` and ``update()`` every k-th micro-step: the gradients
    of k micro-batches are averaged into one optimizer step, the parameters
    stay bitwise unchanged in between and the BatchNorm statistics move at
    every micro-step, as ``optax.MultiSteps`` does in the JAX package (which
    keeps a running mean where this keeps the sum, the same up to f32
    rounding).

    ``reduce`` is the hook of data parallelism (None on one device): a
    ``parallel.data_parallel.Reducer`` that a data-parallel trainer sets.
    A step run with ``update=True`` then averages the gradients and the
    BatchNorm buffers (``buffers``) over the ranks and reduces its metrics
    (``sync``) between the backward and the update, where the JAX step
    ``pmean``s / ``psum``s over its ``axis_name``.  The trainer calls
    ``sync`` itself after its CUDA graph's replay (``modules/
    DistributedTrainer.py``), since a collective stays outside a capture.
    """

    def __init__(self, cfg, model, optimizer):
        self.cfg, self.model, self.optimizer = cfg, model, optimizer
        self.accum_steps = int(cfg.TRAIN.GRAD_ACCUM_STEPS)
        params = list(model.parameters())
        self.class_weights = class_weights_of(cfg, params[0].device)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.grads = [p.grad for p in params]
        torch._foreach_zero_(self.grads)
        self.buffers = [b for b in model.buffers() if b.is_floating_point()]
        self.reduce = None
        self.frozen_grads = [p.grad for p in frozen_params(
            model, cfg.TRAIN.FROZEN_PATTERNS)]

    def __call__(self, batch, generator, level_caps=None, update=True):
        cfg = self.cfg
        self.model.train()
        with record_function("train_step.forward"):
            hier = step_hier(cfg, batch, level_caps)
            out = self.model(batch, hier, generator=generator)
            total, parts = losses(cfg, out, batch, self.class_weights)
        with record_function("train_step.backward"):
            total.backward()
        with record_function("train_step.metrics"), torch.no_grad():
            metrics = {k: v.detach() for k, v in parts.items()}
            metrics["total_loss"] = total.detach()
            if hier is not None:
                metrics.update(overflow_metrics(cfg, batch, hier))
            metrics.update(confusions(cfg, out, batch))
        if update:
            metrics = self.sync(metrics)
            self.update()
        return metrics

    def sync(self, metrics, grads=True):
        """The cross-rank reductions of ``reduce`` (none on one device): the
        metrics reduced (returned), the BatchNorm buffers and, with
        ``grads``, the gradients averaged in place."""
        if self.reduce is None:
            return metrics
        with record_function("train_step.reduce"):
            metrics = self.reduce.metrics(metrics)
            self.reduce.mean_(self.buffers)
            if grads:
                self.reduce.mean_(self.grads)
            return metrics

    def update(self):
        with record_function("train_step.optimizer"):
            apply_gradients(self.optimizer, self.grads, self.accum_steps,
                            self.frozen_grads)


def apply_gradients(optimizer, grads, accum_steps=1, frozen_grads=()):
    """One optimizer step on the static gradients ``grads`` (the sum of
    ``accum_steps`` micro-batches' gradients): zero ``frozen_grads``, take
    the mean, step, zero ``grads`` for the next window."""
    if frozen_grads:
        torch._foreach_zero_(list(frozen_grads))
    if accum_steps > 1:
        torch._foreach_mul_(grads, 1.0 / accum_steps)
    optimizer.step()
    torch._foreach_zero_(grads)


def make_train_step(cfg, model, optimizer):
    """The train step (``TrainStep``) of ``model`` and ``optimizer``."""
    return TrainStep(cfg, model, optimizer)


def make_eval_step(cfg, model):
    """``step(batch, level_caps=None) -> results``, as device tensors: per
    present stream its prediction and CE (``pred_3d`` / ``seg_loss_3d``
    with the 3D stream, ``pred_2d`` / ``seg_loss_2d`` with the image
    stream), and for a fusion model ``pred_ensemble``, the argmax of the
    sum of the 2D and 3D softmaxes."""
    class_weights = class_weights_of(cfg, next(model.parameters()).device)
    m = cfg.MODEL

    def step(batch, level_caps=None):
        model.eval()
        with torch.inference_mode():
            out = model(batch, step_hier(cfg, batch, level_caps))
            valid, label = batch["pt_valid"], batch["seg_label"]
            res = {}
            for use, dim, key in ((m.USE_LIDAR, "3d", "lidar_seg_logit"),
                                  (m.USE_IMAGE, "2d", "img_seg_logit")):
                if use:
                    res[f"pred_{dim}"] = torch.argmax(out[key], -1)
                    res[f"seg_loss_{dim}"] = weighted_cross_entropy(
                        out[key], label, valid, class_weights)
            if m.USE_FUSION:
                probs = (torch.softmax(out["img_seg_logit"], -1)
                         + torch.softmax(out["lidar_seg_logit"], -1))
                res["pred_ensemble"] = torch.argmax(probs, -1)
            return res

    return step

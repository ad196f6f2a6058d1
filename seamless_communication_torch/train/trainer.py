"""The finetune trainer (counterpart of
``seamless_communication_tpu/train/trainer.py``): the S2T, S2S and T2S
finetune modes, the label-smoothed NLL (0.2), AdamW with the Myle schedule
and a global-norm clip, frozen modules, patience early stop, NaN abort,
best-model save and an exact train-state resume.

The JAX trainer is functional; here the parameter tree is a plain dict of
tensors (lists per layer, as the rest of the port) that the trainer owns and
updates in place. Under a mesh (``parallel/sharding.py make_mesh``), as the
JAX trainer under its ``jax.sharding.Mesh``: each rank holds its shards of
the leaves that the rules split over "model", takes its rows of each batch
over "data" (the loss and token sums, then the gradients, summed over
"data"), and with ``pp_microbatches`` runs the layer stacks as a GPipe
pipeline over "pipe" (``parallel/pipeline.py``).

Behaviour of the JAX trainer kept on purpose (ROADMAP, Queue 3):
- ``TEXT_TO_SPEECH`` mode trains the S2T loss, as ``make_train_step`` does;
- ``_eval`` uses the S2T loss in every mode;
- there is no dropout;
- v1's conformer batch norm is the folded per-channel affine, trained as two
  parameters.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import math
from functools import partial
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from seamless_communication_torch.device import resolve_device
from seamless_communication_torch.models.unity import model as unity
from seamless_communication_torch.models.unity.builder import UnitYConfig
from seamless_communication_torch.ops.masks import lengths_to_padding_mask
from seamless_communication_torch.parallel.collectives import (
    SHARD_ATTR, all_reduce, model_shard, reduce_from,
)
from seamless_communication_torch.train.loss import (
    chunked_tied_nll_loss, label_smoothed_nll_loss,
)
from seamless_communication_torch.train.lr import myle_lr

logger = logging.getLogger(__name__)


class FinetuneMode(enum.Enum):
    SPEECH_TO_SPEECH = "SPEECH_TO_SPEECH"
    SPEECH_TO_TEXT = "SPEECH_TO_TEXT"
    TEXT_TO_SPEECH = "TEXT_TO_SPEECH"


@dataclasses.dataclass
class FinetuneParams:
    finetune_mode: FinetuneMode = FinetuneMode.SPEECH_TO_TEXT
    save_model_path: str = "checkpoint"
    float_dtype: torch.dtype = torch.bfloat16   # the trained parameters' dtype
    max_epochs: int = 10
    label_smoothing: float = 0.2
    warmup_steps: int = 100
    learning_rate: float = 1e-7
    weight_decay: float = 0.0
    patience: int = 3
    eval_steps: int = 50
    log_steps: int = 10
    freeze_text_encoder: bool = True
    freeze_speech_encoder: bool = False
    remat: Optional[str] = None    # None, "full", "dots" or "offload_dots": ops/remat.py
    pp_microbatches: int = 0   # >0 + a mesh with a "pipe" axis: the layer
                               # stacks run as a GPipe pipeline with this many
                               # micro-batches (parallel/pipeline.py); 0 = off


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def named_leaves(tree, path: tuple = ()) -> Iterator[tuple[tuple, torch.Tensor]]:
    """(path, tensor) of every leaf of a tree of dicts and lists; a path is
    the tuple of dict keys and list indices (as str) down to the leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, path + (str(i),))
    else:
        yield path, tree


def map_tree(fn: Callable, tree):
    """The tree with ``fn`` applied to every leaf (dicts and lists kept)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def trainable_copy(params: dict, device: torch.device,
                   dtype: Optional[torch.dtype] = None) -> dict:
    """A copy of ``params`` on ``device`` whose every leaf is a tensor of its
    own that requires grad, its floating leaves cast to ``dtype`` (None: kept
    as they are). A table shared by several leaves (the text
    encoder's embedding is the decoder's in ``unity_init``) becomes one copy
    for each: ``jax.grad`` and optax treat the leaves of a tree as separate
    parameters, so after a step with the text encoder frozen the decoder's
    table has moved and the encoder's has not."""
    def leaf(t: torch.Tensor) -> torch.Tensor:
        cast = dtype if dtype is not None and t.is_floating_point() else t.dtype
        return t.detach().to(device, cast, copy=True).requires_grad_(True)

    return map_tree(leaf, params)


def freeze_modules(*names: str) -> Callable:
    """The predicate of paths under the top-level modules ``names``."""
    def predicate(path) -> bool:
        return len(path) > 0 and path[0] in names
    return predicate


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _param_dtype(params: dict) -> torch.dtype:
    return next(named_leaves(params))[1].dtype


def _text_features(params: dict, cfg: UnitYConfig, batch: dict) -> torch.Tensor:
    """The speech encoder and the teacher-forced text decoder -> (B, L, D).
    The fbank is cast to the parameters' dtype first (the reference
    trainer's float_dtype cast), so the whole forward runs in that dtype."""
    fbank = batch["fbank"].to(_param_dtype(params))
    enc = unity.encode_speech(params, cfg, fbank, batch["fbank_lens"])
    return unity.decode_text(params, cfg, batch["prev_tokens"], enc,
                             self_lengths=batch["target_lens"])


def _text_loss(params: dict, cfg: UnitYConfig, feats: torch.Tensor, batch: dict,
               label_smoothing: float):
    """The text NLL of the decoder's features. At a vocabulary of 65536
    entries or more the tied projection and loss run in chunks of 32
    positions (``chunked_tied_nll_loss``), so the (B, L, V) fp32 logits are
    never whole; below it, on the whole logits."""
    vocab_chunk = 32 if cfg.nllb.vocab_size >= 65536 else 0
    # ignore_prefix_size=1: the language token is forced, not predicted
    if vocab_chunk:
        return chunked_tied_nll_loss(
            feats, params["text_decoder"]["embed"], batch["target_tokens"],
            pad_idx=cfg.nllb.pad_idx, label_smoothing=label_smoothing,
            ignore_prefix_size=1, chunk=vocab_chunk)
    return label_smoothed_nll_loss(
        unity.project(params, feats), batch["target_tokens"], pad_idx=cfg.nllb.pad_idx,
        label_smoothing=label_smoothing, ignore_prefix_size=1,
        vocab_shard=model_shard(params["text_decoder"]["embed"].get("embedding")))


def s2t_loss(params: dict, cfg: UnitYConfig, batch: dict, *,
             label_smoothing: float = 0.2):
    """Speech -> text loss -> (summed loss, target tokens). ``batch``: fbank
    (B, T, 80), fbank_lens, prev_tokens (B, L), target_tokens (B, L),
    target_lens, as tensors on the parameters' device."""
    feats = _text_features(params, cfg, batch)
    return _text_loss(params, cfg, feats, batch, label_smoothing)


def s2st_loss(params: dict, cfg: UnitYConfig, batch: dict, *,
              label_smoothing: float = 0.2):
    """SPEECH_TO_SPEECH: the S2T loss plus the T2U loss -> (summed loss,
    tokens + units (+ chars)).

    - AR T2U (v1): the teacher-forced unit NLL; the batch carries
      prev_units, target_units and unit_lens.
    - NAR T2U (v2): the unit NLL with the ground-truth per-char durations
      plus the log1p-duration MSE, one count per char; the batch carries
      char_ids (B, C), char_counts (B, L), target_durations (B, C) and
      target_units (B, U).

    The JAX function runs the speech encoder and the text decoder twice,
    once inside its S2T loss and once for the T2U; this one runs them once
    and uses the features for both. The loss is the same, and so is the
    gradient: the two copies' gradients sum to the one pass's."""
    from seamless_communication_torch.models.unity.t2u import (
        ar_t2u_encode, nar_t2u_train,
    )
    from seamless_communication_torch.ops.transformer import (
        embedding_frontend, tied_projection, transformer_decoder,
    )

    feats = _text_features(params, cfg, batch)
    s2t, n_text = _text_loss(params, cfg, feats, batch, label_smoothing)

    if cfg.ar_t2u is not None:
        tcfg = cfg.ar_t2u
        t2u_enc, t2u_mask = ar_t2u_encode(params["t2u"], tcfg, feats, batch["target_lens"])
        units = batch["prev_units"]
        x = embedding_frontend(params["t2u"]["embed"], units, tcfg.dec_cfg(),
                               padding_mask=lengths_to_padding_mask(batch["unit_lens"],
                                                                    units.shape[1]))
        dec = transformer_decoder(params["t2u"]["decoder"], x, tcfg.dec_cfg(),
                                  enc_out=t2u_enc, enc_padding_mask=t2u_mask)
        unit_logits = tied_projection(params["t2u"]["embed"], dec)
        t2u, n_units = label_smoothed_nll_loss(
            unit_logits, batch["target_units"], pad_idx=tcfg.pad_idx,
            label_smoothing=label_smoothing, ignore_prefix_size=1,
            vocab_shard=model_shard(params["t2u"]["embed"].get("embedding")))
        return s2t + t2u, n_text + n_units

    if cfg.nar_t2u is not None:
        tcfg = cfg.nar_t2u
        out = nar_t2u_train(params["t2u"], tcfg, feats, batch["target_lens"],
                            batch["char_ids"], batch["char_counts"],
                            batch["target_durations"],
                            max_unit_len=batch["target_units"].shape[1])
        t2u, n_units = label_smoothed_nll_loss(
            out.unit_logits, batch["target_units"], pad_idx=tcfg.pad_idx,
            label_smoothing=label_smoothing)
        # the log-duration MSE (FastSpeech2): target log1p(duration), one
        # loss token per char
        dur_tgt = torch.log1p(batch["target_durations"].float())
        cmask = out.char_mask.float()
        dur_mse = ((out.log_dur_pred.float() - dur_tgt).square() * cmask).sum()
        n_chars = torch.clamp_min(cmask.sum(), 1.0)
        return s2t + t2u + dur_mse, n_text + n_units + n_chars

    return s2t, n_text


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

MAX_GRAD_NORM = 1.0     # the JAX trainer's clip_by_global_norm(1.0)


class AdamWMyle:
    """``optax.chain(clip_by_global_norm(MAX_GRAD_NORM), adamw(myle_lr(lr,
    warmup), b1=0.9, b2=0.98, eps=1e-8, weight_decay=wd))`` over the tensors
    ``params``, each listed once: ``torch.optim.AdamW`` at rate 1 scaled by
    ``LambdaLR(myle_lr)``, so that update n uses ``myle_lr(n)`` as optax's
    count gives it, after optax's clip ``g / ||g|| * MAX_GRAD_NORM`` where
    the global norm ``||g||`` (fp32) is at least ``MAX_GRAD_NORM``. AdamW updates
    every tensor with a gradient: the trainer gives frozen and unused ones
    zeros, so weight decay still moves them, as in optax."""

    def __init__(self, params: list, learning_rate: float, warmup_steps: int,
                 weight_decay: float = 0.0):
        self.params = params
        self.opt = torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.98), eps=1e-8,
                                     weight_decay=weight_decay)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.opt, myle_lr(learning_rate, warmup_steps))

    def global_norm(self) -> torch.Tensor:
        """The norm of the whole gradient: a leaf split over "model" counts
        its shards' squares summed over the axis, a replicated leaf once."""
        norms = [torch.linalg.vector_norm(p.grad, dtype=torch.float32)
                 for p in self.params]
        split = [i for i, p in enumerate(self.params) if model_shard(p) is not None]
        if split:
            axis = model_shard(self.params[split[0]]).axis
            sq = all_reduce(torch.stack([norms[i] for i in split]).square(), axis)
            for j, i in enumerate(split):
                norms[i] = sq[j].sqrt()
        return torch.linalg.vector_norm(torch.stack(norms))

    def step(self) -> float:
        """Clip, update, advance the schedule; returns the gradients' global
        norm before the clip."""
        norm = self.global_norm()
        value = float(norm)
        if not value < MAX_GRAD_NORM:
            grads = [p.grad for p in self.params]
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, MAX_GRAD_NORM)
        self.opt.step()
        self.schedule.step()
        return value

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def steps_taken(self) -> int:
        return self.schedule.last_epoch

    def moments(self) -> dict:
        """{"exp_avg": [...], "exp_avg_sq": [...]}, a tensor for each of
        ``params`` (zeros before the first step)."""
        out: dict = {"exp_avg": [], "exp_avg_sq": []}
        for p in self.params:
            st = self.opt.state.get(p, {})
            for k in out:
                out[k].append(st[k] if k in st else torch.zeros_like(p))
        return out

    def restore(self, moments: dict, steps: int) -> None:
        """The state after ``steps`` updates with the given moments: AdamW's
        per-tensor state and the schedule's position and rate."""
        for i, p in enumerate(self.params):
            self.opt.state[p] = {"step": torch.tensor(float(steps)),
                                 "exp_avg": moments["exp_avg"][i],
                                 "exp_avg_sq": moments["exp_avg_sq"][i]}
        self.schedule.last_epoch = steps
        lrs = [base * lmbda(steps) for base, lmbda in zip(self.schedule.base_lrs,
                                                          self.schedule.lr_lambdas)]
        for group, lr in zip(self.opt.param_groups, lrs):
            group["lr"] = lr
        self.schedule._last_lr = lrs


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def batch_to(batch: dict, device: torch.device) -> dict:
    """Every array of a batch as a tensor on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               device=device) for k, v in batch.items()}


def _sum_over(tensors: list, axis) -> None:
    """Sum ``tensors`` over ``axis`` in place, one collective a dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = all_reduce(torch.cat([t.reshape(-1) for t in group]), axis)
        o = 0
        for t in group:
            t.copy_(flat[o:o + t.numel()].view_as(t))
            o += t.numel()


def make_train_step(cfg: UnitYConfig, optimizer: AdamWMyle, *,
                    label_smoothing: float = 0.2, mode: Optional[FinetuneMode] = None,
                    frozen_predicate: Optional[Callable] = None,
                    remat: Optional[str] = None, mesh=None, pp_n_micro: int = 0
                    ) -> Callable:
    """The train step ``step(params, batch) -> {"loss", "n_tokens", "grad_norm"}``:
    the loss per token (summed loss over max(tokens, 1)), its backward, the
    gradients of frozen leaves (``frozen_predicate(path)``) and of leaves no
    loss reached set to zeros (``jax.grad``'s zeros), then one update of
    ``optimizer``, in place. ``remat``: None, "full", "dots" or
    "offload_dots" (``ops/remat.py``). ``SPEECH_TO_SPEECH`` trains
    ``s2st_loss``, every other mode ``s2t_loss``, as the JAX step does.

    ``mesh``: ``batch`` is this rank's rows of the global batch split over
    "data"; the summed loss and the token count are summed over "data"
    (JAX's global loss over global tokens, not a mean of the ranks' means)
    and so are the gradients. With ``pp_n_micro`` > 0 and a "pipe" axis
    of more than one rank, the layer stacks run as a GPipe pipeline over it
    with ``pp_n_micro`` micro-batches (``parallel/pipeline.py``; JAX's
    ``pp_mesh``); 0: no pipeline."""
    base = s2st_loss if mode == FinetuneMode.SPEECH_TO_SPEECH else s2t_loss
    loss_fn = partial(base, label_smoothing=label_smoothing)
    if remat is not None:
        from seamless_communication_torch.ops.remat import remat_layers

        inner_loss = loss_fn

        def loss_fn(p, cfg, batch):
            with remat_layers(remat):
                return inner_loss(p, cfg, batch)
    if pp_n_micro > 0 and mesh is not None and mesh.size("pipe") > 1:
        from seamless_communication_torch.parallel.pipeline import pipeline_layers

        pp_inner = loss_fn

        def loss_fn(p, cfg, batch):
            with pipeline_layers(mesh, n_micro=pp_n_micro):
                return pp_inner(p, cfg, batch)
    data = mesh.axis("data") if mesh is not None else None

    def step(params: dict, batch: dict) -> dict:
        optimizer.zero_grad()
        loss_sum, n_tokens = loss_fn(params, cfg, batch)
        if data is not None and data.size > 1:
            loss_sum = reduce_from(loss_sum, data)
            n_tokens = all_reduce(n_tokens, data)
        loss = loss_sum / torch.clamp_min(n_tokens, 1.0)
        loss.backward()
        trained = []
        for path, t in named_leaves(params):
            if t.grad is None or (frozen_predicate is not None and frozen_predicate(path)):
                t.grad = torch.zeros_like(t)
            else:
                trained.append(t.grad)
        if data is not None and data.size > 1:
            _sum_over(trained, data)
        grad_norm = optimizer.step()
        return {"loss": loss.detach(), "n_tokens": n_tokens.detach(),
                "grad_norm": grad_norm}

    return step


class UnitYFinetune:
    """The training loop of the JAX ``UnitYFinetune``: epochs over
    ``train_data`` (an iterable of batches of arrays), the S2T eval loss on
    ``eval_data`` every ``eval_steps``, patience early stop, NaN abort and
    best-model save. ``device=None`` trains on the card (and raises without
    one); the tests pass ``device="cpu"``. The trainer trains its own copy of
    ``params`` in ``ft.float_dtype`` (``trainable_copy``), in ``self.params``:
    under ``mesh`` (``parallel/sharding.py make_mesh``) this rank's shards
    (``shard_params``), each batch and eval batch split over "data", and
    with ``ft.pp_microbatches`` > 0 on a mesh with "pipe" > 1 the pipeline."""

    def __init__(self, params: dict, cfg: UnitYConfig, ft: FinetuneParams, *,
                 mesh=None, train_data=None, eval_data=None, device=None):
        self.cfg = cfg
        self.ft = ft
        self.mesh = mesh
        self.device = resolve_device(device)
        self.train_data = train_data
        self.eval_data = eval_data
        self.params = trainable_copy(params, self.device, ft.float_dtype)
        self.split = lambda batch: batch
        if mesh is not None:
            from seamless_communication_torch.parallel.sharding import (
                data_sharding, shard_params,
            )
            self.params = shard_params(self.params, mesh)
            self.split = data_sharding(mesh)
        leaves = [t for _, t in named_leaves(self.params)]
        self.optimizer = AdamWMyle(leaves, ft.learning_rate, ft.warmup_steps,
                                   ft.weight_decay)
        frozen = [name for name, on in (("text_encoder", ft.freeze_text_encoder),
                                        ("speech_encoder", ft.freeze_speech_encoder))
                  if on]
        self.train_step = make_train_step(
            cfg, self.optimizer, label_smoothing=ft.label_smoothing,
            mode=ft.finetune_mode,
            frozen_predicate=freeze_modules(*frozen) if frozen else None,
            remat=ft.remat, mesh=mesh, pp_n_micro=ft.pp_microbatches)
        self.best_eval = float("inf")
        self.patience_left = ft.patience
        self.step_losses: list = []     # each step's loss in ``run``

    def step(self, batch: dict) -> dict:
        """One train step on a (global) batch of arrays."""
        return self.train_step(self.params, batch_to(self.split(batch), self.device))

    def _eval(self) -> float:
        """The S2T loss per token over ``eval_data``: the sums over every
        batch (each split over "data" and summed over it under a mesh)."""
        if self.eval_data is None:
            return float("nan")
        data = self.mesh.axis("data") if self.mesh is not None else None
        loss, count = 0.0, 0.0
        with torch.no_grad():
            for batch in self.eval_data:
                l, n = s2t_loss(self.params, self.cfg,
                                batch_to(self.split(batch), self.device),
                                label_smoothing=self.ft.label_smoothing)
                if data is not None:
                    l, n = all_reduce(torch.stack([l.float(), n.float()]), data)
                loss += float(l)
                count += float(n)
        return loss / max(count, 1.0)

    def save(self) -> None:
        """The parameters (the best model so far) to ``save_model_path``: a
        checkpoint directory (``checkpoint/serialize.py save_params``; each
        rank its shards under a mesh), or a ``.npz`` file."""
        from seamless_communication_torch.checkpoint.serialize import save_params

        save_params(self.ft.save_model_path, self.params, mesh=self.mesh)
        logger.info("saved checkpoint to %s", self.ft.save_model_path)

    def _state_tensors(self, step_nr: int = 0) -> dict:
        """The flat state of a checkpoint directory: the parameters, AdamW's
        moments (each shaped and split as its parameter), the optimizer's
        step count and the counters, each a tensor."""
        from seamless_communication_torch.checkpoint.serialize import flat_tensors

        params = flat_tensors(self.params)
        state = {f"params.{k}": t for k, t in params.items()}
        for name, tensors in self.optimizer.moments().items():
            for (k, p), m in zip(params.items(), tensors):
                if model_shard(p) is not None:
                    setattr(m, SHARD_ATTR, model_shard(p))
                state[f"{name}.{k}"] = m
        state["optimizer.steps"] = torch.tensor(self.optimizer.steps_taken())
        state["counters.step"] = torch.tensor(step_nr)
        state["counters.best_eval"] = torch.tensor(self.best_eval, dtype=torch.float64)
        state["counters.patience_left"] = torch.tensor(self.patience_left)
        return state

    def save_state(self, path: str, step_nr: int) -> None:
        """The whole training state (parameters, optimizer and schedule,
        step counter, early-stop bookkeeping) for an exact resume: a
        checkpoint directory at ``path``, each rank its shards under a
        mesh."""
        from seamless_communication_torch.checkpoint.serialize import save_dir

        save_dir(path, self._state_tensors(step_nr), self.mesh)
        logger.info("saved train state (step %d) to %s", step_nr, path)

    def restore_state(self, path: str) -> int:
        """Restore a ``save_state`` directory, written under any mesh or
        none, into this trainer's mesh; returns its step counter."""
        from seamless_communication_torch.checkpoint.serialize import load_dir_into

        state = self._state_tensors()
        for k in ("optimizer.steps", "counters.step", "counters.best_eval",
                  "counters.patience_left"):
            state[k] = state[k].clone()
        load_dir_into(path, state, self.mesh)
        keys = [k[len("params."):] for k in state if k.startswith("params.")]
        moments = {name: [state[f"{name}.{k}"] for k in keys]
                   for name in ("exp_avg", "exp_avg_sq")}
        self.optimizer.restore(moments, int(state["optimizer.steps"]))
        self.best_eval = float(state["counters.best_eval"])
        self.patience_left = int(state["counters.patience_left"])
        step_nr = int(state["counters.step"])
        logger.info("restored train state (step %d) from %s", step_nr, path)
        return step_nr

    def run(self, start_step: int = 0) -> int:
        """Train; returns the final step counter (pass it back as
        ``start_step`` after ``restore_state``)."""
        step_nr = start_step
        for _ in range(self.ft.max_epochs):
            for batch in self.train_data:
                loss = float(self.step(batch)["loss"])
                self.step_losses.append(loss)
                if math.isnan(loss):
                    raise RuntimeError(f"NaN loss at step {step_nr}")
                step_nr += 1
                if step_nr % self.ft.log_steps == 0:
                    logger.info("step %d loss %.4f", step_nr, loss)
                if step_nr % self.ft.eval_steps == 0:
                    ev = self._eval()
                    logger.info("eval loss %.4f", ev)
                    if ev < self.best_eval:
                        self.best_eval = ev
                        self.patience_left = self.ft.patience
                        self.save()
                    else:
                        self.patience_left -= 1
                        if self.patience_left <= 0:
                            logger.info("early stop (patience)")
                            return step_nr
        return step_nr

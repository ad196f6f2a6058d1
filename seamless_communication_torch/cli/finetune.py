"""``m4t_finetune`` (counterpart of ``seamless_communication_tpu/cli/finetune.py``):
finetune a UnitY model on a local manifest over a data-, tensor- and
pipeline-parallel mesh.

    python -m seamless_communication_torch.cli.finetune \
        --train_dataset train.json --eval_dataset eval.json \
        --model_name seamlessM4T_v2_large --local_pt_path model.pt \
        --save_model_to best_dir --save_state_to state_dir

One process trains on one card (``--device cpu`` on the CPU). Under
``torchrun`` (``WORLD_SIZE`` > 1) the process group is started here unless
it is already: NCCL on CUDA, gloo on the CPU; the mesh is
``--data_parallel`` x ``--model_parallel`` x ``--pipeline_parallel`` ranks
(data 0: the world size over model x pipe), each rank on the card of its
``LOCAL_RANK`` under NCCL.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import NamedTuple, Optional, Sequence

logger = logging.getLogger("m4t_finetune")


class FinetuneResult(NamedTuple):
    trainer: object         # the UnitYFinetune, its params and step losses
    final_step: int


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="M4T finetuning")
    parser.add_argument("--train_dataset", type=str, required=True,
                        help="train manifest (JSON lines of audio/text pairs)")
    parser.add_argument("--eval_dataset", type=str, default=None)
    parser.add_argument("--model_name", type=str, default="seamlessM4T_v2_large")
    parser.add_argument("--save_model_to", type=str, default="checkpoint")
    parser.add_argument("--mode", type=str, default="SPEECH_TO_TEXT",
                        choices=["SPEECH_TO_SPEECH", "SPEECH_TO_TEXT", "TEXT_TO_SPEECH"])
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--learning_rate", type=float, default=1e-7)
    parser.add_argument("--warmup_steps", type=int, default=100)
    parser.add_argument("--max_epochs", type=int, default=10)
    parser.add_argument("--patience", type=int, default=3)
    parser.add_argument("--eval_steps", type=int, default=50)
    parser.add_argument("--log_steps", type=int, default=10)
    parser.add_argument("--label_smoothing", type=float, default=0.2)
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="0 = the world size over model x pipe")
    parser.add_argument("--model_parallel", type=int, default=1)
    parser.add_argument("--pipeline_parallel", type=int, default=1,
                        help="GPipe pipeline stages over a 'pipe' mesh axis "
                             "(parallel/pipeline.py); layer counts must divide it")
    parser.add_argument("--pp_microbatches", type=int, default=2,
                        help="micro-batches per pipeline step (bubble = "
                             "(S-1)/(m+S-1)); batch_size must divide "
                             "data_parallel * pp_microbatches")
    parser.add_argument("--freeze_text_encoder", action=argparse.BooleanOptionalAction,
                        default=True, help="--no-freeze_text_encoder unfreezes it")
    parser.add_argument("--freeze_speech_encoder", action="store_true")
    parser.add_argument("--local_hf_path", type=str, default=None)
    parser.add_argument("--local_pt_path", type=str, default=None,
                        help="a local original .pt checkpoint of the card's model")
    parser.add_argument("--device", type=str, default=None,
                        help="cpu, or a card (the default: the card)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each layer's activations in the backward "
                             "(ops/remat.py, policy 'full')")
    parser.add_argument("--resume", type=str, default=None,
                        help="restore a train-state directory written by "
                             "--save_state_to (params, optimizer, counters)")
    parser.add_argument("--save_state_to", type=str, default=None,
                        help="write a resumable train-state directory when "
                             "training ends")
    parser.add_argument("--init_speech_encoder", type=str, default=None,
                        help="a standalone conformer-shaw .pt "
                             "(cards/conformer_shaw.yaml): the speech encoder's "
                             "conformer stack and frontend projection start "
                             "from it")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> FinetuneResult:
    """Parse ``argv`` (``sys.argv[1:]`` when None), load the model, build
    the mesh, the loaders and the trainer, train, and save the train state
    (in ``finally``, as the JAX CLI does)."""
    logging.basicConfig(level=logging.INFO)
    parser = build_parser()
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from seamless_communication_torch.cli import loading
    from seamless_communication_torch.datasets.loader import manifest_batches
    from seamless_communication_torch.parallel.sharding import init_distributed, make_mesh
    from seamless_communication_torch.train.trainer import (
        FinetuneMode, FinetuneParams, UnitYFinetune,
    )

    device = args.device
    in_group = init_distributed(device)
    if in_group and device is None and dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"

    params, cfg, text_tok, _, char_tok = loading.load_unity_model_and_tokenizers(
        args.model_name, local_hf_path=args.local_hf_path,
        local_pt_path=args.local_pt_path, device=device)

    if args.init_speech_encoder:
        from seamless_communication_torch.checkpoint.convert_fairseq2 import (
            init_speech_encoder_from_conformer_shaw, load_pt_state_dict,
        )
        logger.info("initializing speech encoder from %s", args.init_speech_encoder)
        params = init_speech_encoder_from_conformer_shaw(
            params, load_pt_state_dict(args.init_speech_encoder))

    pp, mp = args.pipeline_parallel, args.model_parallel
    world = dist.get_world_size() if in_group else 1
    dp = args.data_parallel or world // (mp * pp)
    mesh = make_mesh(data=dp, model=mp, pipe=pp)
    logger.info("mesh: data=%d model=%d pipe=%d", dp, mp, pp)

    ft = FinetuneParams(
        finetune_mode=FinetuneMode(args.mode), save_model_path=args.save_model_to,
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
        max_epochs=args.max_epochs, patience=args.patience, eval_steps=args.eval_steps,
        log_steps=args.log_steps, label_smoothing=args.label_smoothing,
        freeze_text_encoder=args.freeze_text_encoder,
        freeze_speech_encoder=args.freeze_speech_encoder,
        remat="full" if args.remat else None,
        pp_microbatches=args.pp_microbatches if pp > 1 else 0)

    # S2S manifests: AR-T2U archs (v1) train on target.units; NAR-T2U archs
    # (v2) also need target.char_durations and the card's char tokenizer
    load_units = ft.finetune_mode == FinetuneMode.SPEECH_TO_SPEECH
    nar_char_tok = None
    if load_units and cfg.ar_t2u is None:
        if char_tok is None:
            parser.error("NAR-T2U S2S finetuning needs the card's char_tokenizer "
                         "(spm_char_lang38_tc.model)")
        nar_char_tok = char_tok

    def batches(path):
        return manifest_batches(path, text_tok, batch_size=args.batch_size,
                                load_units=load_units, char_tokenizer=nar_char_tok)

    trainer = UnitYFinetune(params, cfg, ft, mesh=mesh,
                            train_data=batches(args.train_dataset),
                            eval_data=batches(args.eval_dataset) if args.eval_dataset
                            else None, device=device)
    del params
    step0 = trainer.restore_state(args.resume) if args.resume else 0
    final_step = step0
    try:
        final_step = trainer.run(start_step=step0) or step0
    finally:
        if args.save_state_to:
            trainer.save_state(args.save_state_to, step_nr=final_step)
    return FinetuneResult(trainer, final_step)


if __name__ == "__main__":
    main()

"""spine-vision-torch command line interface.

Counterpart of ``spine_vision_tpu/cli/__init__.py``, with the same
subcommands, flags, defaults and choices:

    spine-vision-torch [--device cuda|cpu] dataset localization [options]
    spine-vision-torch dataset phenikaa [options]
    spine-vision-torch dataset classification [options]
    spine-vision-torch train localization [options]
    spine-vision-torch train classification [options]
    spine-vision-torch evaluate localization --checkpoint-path ...
    spine-vision-torch evaluate classification --checkpoint-path ...
    spine-vision-torch test / infer / serve
    spine-vision-torch convert --checkpoint r18.pth --arch resnet18 --output r18.npz
    spine-vision-torch bench / parity / train-ocr

Configs are the port's dataclasses rendered to argparse options
(``config_args``). Three differences from the JAX CLI, each stated:

- ``--device`` (before the subcommand, default ``cuda``) is passed to every
  trainer, pipeline, extractor and builder the subcommand builds; without a
  card the command raises, unless it is ``--device cpu``. Nothing falls back
  to the CPU.
- ``train-ocr --output-dir`` is required: ``train_ocr_stack`` refuses None,
  which in the JAX package writes over the shipped weights.
- ``bench`` raises ``NotImplementedError`` (ROADMAP Queue 1 item 6): the
  JAX command runs the repository's ``bench.py``, which imports JAX.
"""

from __future__ import annotations

import argparse
import sys

from spine_vision_torch.cli.config_args import add_config_args, config_from_args
from spine_vision_torch.core.logging import logger, setup_logger

BENCH_NOT_PORTED = (
    "spine-vision-torch bench: the port's benchmark harness is not written yet "
    "(ROADMAP.md, Queue 1 item 6); bench.py runs the JAX package"
)


def _build_parser() -> argparse.ArgumentParser:
    from spine_vision_torch.data.builders import (
        ClassificationDatasetConfig,
        LocalizationDatasetConfig,
    )
    from spine_vision_torch.data.phenikaa import PreprocessConfig
    from spine_vision_torch.train.classification import ClassificationConfig
    from spine_vision_torch.train.localization import LocalizationConfig

    parser = argparse.ArgumentParser(
        prog="spine-vision-torch",
        description="Lumbar-spine MRI pipeline on PyTorch and CUDA",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="Device every trainer, pipeline, extractor and builder runs on (default "
        "cuda: a missing card raises; --device cpu runs the plain PyTorch path)",
    )
    commands = parser.add_subparsers(dest="command", required=True)

    dataset = commands.add_parser("dataset", help="Dataset construction")
    dataset_sub = dataset.add_subparsers(dest="subcommand", required=True)
    add_config_args(
        dataset_sub.add_parser("localization", help="Build localization dataset"),
        LocalizationDatasetConfig,
    )
    add_config_args(
        dataset_sub.add_parser("phenikaa", help="Phenikaa OCR preprocessing"),
        PreprocessConfig,
    )
    add_config_args(
        dataset_sub.add_parser(
            "classification", help="Build classification crop dataset"
        ),
        ClassificationDatasetConfig,
    )

    train = commands.add_parser("train", help="Model training")
    train_sub = train.add_subparsers(dest="subcommand", required=True)
    add_config_args(
        train_sub.add_parser("localization", help="Train coordinate regressor"),
        LocalizationConfig,
    )
    add_config_args(
        train_sub.add_parser("classification", help="Train multi-task grader"),
        ClassificationConfig,
    )

    evaluate = commands.add_parser("evaluate", help="Checkpoint evaluation")
    evaluate_sub = evaluate.add_subparsers(dest="subcommand", required=True)
    add_config_args(
        evaluate_sub.add_parser("localization", help="Evaluate localization"),
        LocalizationConfig,
    )
    add_config_args(
        evaluate_sub.add_parser("classification", help="Evaluate classification"),
        ClassificationConfig,
    )

    test = commands.add_parser(
        "test", help="Ad-hoc timed inference on image files"
    )
    test.add_argument("--checkpoint-path", required=True)
    test.add_argument("--images", nargs="+", required=True)
    test.add_argument(
        "--model-kind",
        choices=["classification", "localization"],
        default="classification",
    )
    test.add_argument("--backbone", default="resnet18")
    test.add_argument("--image-size", nargs=2, type=int, default=[256, 256])
    test.add_argument("-v", "--verbose", action="store_true")

    infer = commands.add_parser(
        "infer", help="Fused two-stage study inference (loc -> crop -> grade)"
    )
    infer.add_argument("--loc-checkpoint", required=True)
    infer.add_argument("--cls-checkpoint", required=True)
    infer.add_argument(
        "--t1", required=True, nargs="+",
        help="T1 series per study (DICOM dir / .mha / .nii / .nrrd)",
    )
    infer.add_argument(
        "--t2", required=True, nargs="+", help="T2 series per study"
    )
    infer.add_argument("--loc-backbone", default="convnext_base")
    infer.add_argument("--cls-backbone", default="resnet18")
    infer.add_argument(
        "--crop-mode", choices=["horizontal", "rotated"], default="horizontal"
    )
    infer.add_argument(
        "--padded-hw", nargs=2, type=int, default=None,
        help="Static slice buffer; default auto-buckets (512/768/1024/1536/"
        "2048) from the loaded series so similar sizes share one buffer size",
    )
    infer.add_argument("--output-json", default=None)
    infer.add_argument("-v", "--verbose", action="store_true")

    serve = commands.add_parser(
        "serve",
        help="Batch-serving daemon: drain request JSONs through the fused "
        "study pipeline",
    )
    serve.add_argument("--loc-checkpoint", required=True)
    serve.add_argument("--cls-checkpoint", required=True)
    serve.add_argument(
        "--watch-dir", required=True,
        help='Directory receiving {"study_id","t1","t2"} request JSON files',
    )
    serve.add_argument("--output-dir", required=True)
    serve.add_argument("--loc-backbone", default="convnext_base")
    serve.add_argument("--cls-backbone", default="resnet18")
    serve.add_argument(
        "--crop-mode", choices=["horizontal", "rotated"], default="horizontal"
    )
    serve.add_argument("--padded-hw", nargs=2, type=int, default=[1024, 1024])
    serve.add_argument("--max-batch", type=int, default=16)
    serve.add_argument("--poll-interval", type=float, default=0.5)
    serve.add_argument(
        "--once", action="store_true",
        help="Drain the current backlog and exit (batch-job mode)",
    )
    serve.add_argument(
        "--data-parallel", action="store_true",
        help="Split each request batch over every local CUDA device (one replica a "
        "device, the batch split along its first axis)",
    )
    serve.add_argument("-v", "--verbose", action="store_true")

    convert = commands.add_parser(
        "convert",
        help="Convert a torch backbone checkpoint to the .npz artifact read by "
        "--pretrained-path",
    )
    convert.add_argument(
        "--checkpoint", required=True, help="torch .pth/.pt state-dict file"
    )
    convert.add_argument(
        "--arch", required=True,
        help="Backbone name (models/backbone.py registry, e.g. resnet18)",
    )
    convert.add_argument("--output", required=True, help="Output .npz path")
    convert.add_argument("-v", "--verbose", action="store_true")

    commands.add_parser(
        "bench", help="Run the benchmark harness (not ported: raises, ROADMAP Queue 1 item 6)"
    )

    parity = commands.add_parser(
        "parity",
        help="Quality-parity harness: synthetic loc/cls/fused-infer quality run",
    )
    parity.add_argument("--output-dir", required=True)
    parity.add_argument("--seed", type=int, default=0)
    parity.add_argument(
        "--norm-impl", choices=["tpu", "flax"], default="tpu",
        help="ResNet BatchNorm implementation under test",
    )
    parity.add_argument(
        "--pool-impl", choices=["tpu", "flax"], default="flax",
        help="ResNet stem max-pool implementation under test",
    )
    parity.add_argument("-v", "--verbose", action="store_true")

    ocr = commands.add_parser(
        "train-ocr", help="Train the OCR detector+recognizer on rendered text"
    )
    ocr.add_argument(
        "--output-dir", required=True,
        help="Where the two .npz files go (required: the package's weights/ directory "
        "holds the shipped weights)",
    )
    ocr.add_argument("--recognizer-steps", type=int, default=4000)
    ocr.add_argument("--detector-steps", type=int, default=1200)
    ocr.add_argument("--seed", type=int, default=0)
    ocr.add_argument("-v", "--verbose", action="store_true")
    return parser


def cli(argv: list[str] | None = None) -> int:
    """Console entry point."""
    parser = _build_parser()
    args = parser.parse_args(argv)
    device = args.device
    if args.command not in ("convert", "bench"):
        from spine_vision_torch.device import resolve_device

        try:
            resolve_device(device)
        except RuntimeError as exc:
            raise RuntimeError(f"{exc} On the command line: --device cpu.") from None

    setup_logger(verbose=getattr(args, "verbose", False))

    if args.command == "dataset":
        if args.subcommand == "localization":
            from spine_vision_torch.data.builders import (
                LocalizationDatasetConfig,
                create_localization_dataset,
            )

            config = config_from_args(LocalizationDatasetConfig, args)
            config.output_path.mkdir(parents=True, exist_ok=True)
            result = create_localization_dataset(config, device=device)
        elif args.subcommand == "phenikaa":
            from spine_vision_torch.data.phenikaa import PreprocessConfig, preprocess_phenikaa

            result = preprocess_phenikaa(config_from_args(PreprocessConfig, args), device=device)
        else:
            from spine_vision_torch.data.builders import (
                ClassificationDatasetConfig,
                create_classification_dataset,
            )

            config = config_from_args(ClassificationDatasetConfig, args)
            config.output_path.mkdir(parents=True, exist_ok=True)
            result = create_classification_dataset(config, device=device)
        logger.info("%s", result.summary)
        return 0

    if args.command in ("train", "evaluate"):
        from spine_vision_torch.cli import train as commands
        from spine_vision_torch.train.classification import ClassificationConfig
        from spine_vision_torch.train.localization import LocalizationConfig

        config_cls = LocalizationConfig if args.subcommand == "localization" else (
            ClassificationConfig)
        run = getattr(commands, f"{args.command}_{args.subcommand}")
        run(config_from_args(config_cls, args), device=device)
        return 0

    if args.command == "test":
        from spine_vision_torch.cli import train as commands

        commands.test_inference_command(
            checkpoint_path=args.checkpoint_path,
            images=args.images,
            model_kind=args.model_kind,
            backbone=args.backbone,
            image_size=tuple(args.image_size),
            device=device,
        )
        return 0

    if args.command == "infer":
        import json
        from pathlib import Path

        from spine_vision_torch.infer import (
            StudyInferencePipeline,
            StudyPipelineConfig,
            study_input_from_paths,
        )

        if len(args.t1) != len(args.t2):
            parser.error("--t1 and --t2 must list the same number of series")
        studies = [
            study_input_from_paths(t1, t2, study_id=f"study{i}", device=device)
            for i, (t1, t2) in enumerate(zip(args.t1, args.t2))
        ]
        if args.padded_hw is not None:
            padded_hw = tuple(args.padded_hw)
        else:
            # Auto-bucket: the smallest standard size covering every slice,
            # so runs over similar series share one buffer size instead of
            # the user guessing a big-enough static buffer.
            largest = max(max(s.t1_slice.shape + s.t2_slice.shape) for s in studies)
            padded_hw = next(
                ((b, b) for b in (512, 768, 1024, 1536, 2048) if b >= largest),
                (-(-largest // 256) * 256,) * 2,
            )
            logger.info("Auto-selected padded_hw bucket: %s", padded_hw)
        pipeline = StudyInferencePipeline.from_checkpoints(
            loc_checkpoint=args.loc_checkpoint,
            cls_checkpoint=args.cls_checkpoint,
            loc_backbone=args.loc_backbone,
            cls_backbone=args.cls_backbone,
            config=StudyPipelineConfig(crop_mode=args.crop_mode, padded_hw=padded_hw),
            device=device,
        )
        results = pipeline.run(studies, fetch_crops=False)
        payload = [
            {
                "study_id": r.study_id,
                "coords": r.coords.tolist(),
                "predictions": {k: v.tolist() for k, v in r.predictions.items()},
                "probabilities": {k: v.tolist() for k, v in r.probabilities.items()},
            }
            for r in results
        ]
        text = json.dumps(payload, indent=2)
        if args.output_json:
            out_path = Path(args.output_json)
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(text)
            logger.info("Wrote predictions to %s", args.output_json)
        else:
            print(text)
        return 0

    if args.command == "serve":
        from pathlib import Path

        from spine_vision_torch.infer import StudyInferencePipeline, StudyPipelineConfig
        from spine_vision_torch.infer.serve import serve_directory

        mesh = None
        if args.data_parallel:
            from spine_vision_torch.parallel import data_parallel_mesh

            mesh = data_parallel_mesh()
            logger.info("Serving data-parallel over %d devices", len(mesh))
        pipeline = StudyInferencePipeline.from_checkpoints(
            loc_checkpoint=args.loc_checkpoint,
            cls_checkpoint=args.cls_checkpoint,
            loc_backbone=args.loc_backbone,
            cls_backbone=args.cls_backbone,
            config=StudyPipelineConfig(crop_mode=args.crop_mode,
                                       padded_hw=tuple(args.padded_hw)),
            device=device,
            mesh=mesh,
        )
        stats = serve_directory(
            pipeline,
            Path(args.watch_dir),
            Path(args.output_dir),
            poll_interval=args.poll_interval,
            max_batch=args.max_batch,
            once=args.once,
        )
        logger.info("Serve loop done: %d processed, %d failed, %d batches",
                    stats.processed, stats.failed, stats.batches)
        return 0

    if args.command == "convert":
        from pathlib import Path

        from spine_vision_torch.models.convert import convert_checkpoint

        convert_checkpoint(Path(args.checkpoint), args.arch, Path(args.output))
        return 0

    if args.command == "bench":
        raise NotImplementedError(BENCH_NOT_PORTED)

    if args.command == "parity":
        import json
        from pathlib import Path

        from spine_vision_torch.utils.parity import run_parity

        record = run_parity(
            Path(args.output_dir),
            seed=args.seed,
            norm_impl=args.norm_impl,
            pool_impl=args.pool_impl,
            device=device,
        )
        print(json.dumps(record, indent=2))
        return 0 if record["all_pass"] else 1

    if args.command == "train-ocr":
        import json
        from pathlib import Path

        from spine_vision_torch.train.ocr import train_ocr_stack

        metrics = train_ocr_stack(
            output_dir=Path(args.output_dir),
            recognizer_steps=args.recognizer_steps,
            detector_steps=args.detector_steps,
            seed=args.seed,
            device=device,
        )
        print(json.dumps(metrics, indent=2))
        return 0

    parser.error(f"Unknown command: {args.command}")
    return 2


def main() -> None:  # console_scripts target
    sys.exit(cli())

"""Command line of the port: export and weight conversion.

    python -m vision_kit_tpu_torch export -c CONFIG [--ckpt PATH] [--output-dir DIR]
        [--onnx] [--torchscript] [--device cuda]
    python -m vision_kit_tpu_torch convert WEIGHTS [-m yolov5|yolov7] [-v s]
        [-n 80] [-o OUT] [--from-upstream] [--reparameterize]

`export` is the counterpart of scripts/main.py's export task: the config's
model, its weights from --ckpt or else from cfg.model.weight when that file
exists (predictor.load_weights), written by export.run_export to
`<output dir>/weights` (the output dir is cfg.data.output_dir unless
--output-dir names another).

`convert` is the counterpart of scripts/convert.py: a vision_kit-format
`.pt`/`.ckpt`, or with --from-upstream a local ultralytics / WongKinYiu
`.pt` zipped by position onto the reference's key order, checked key for
key and shape for shape against the model and written as a
`{"model": state_dict}` `.pt` in f32; --reparameterize folds a YOLOv7
head's implicit layers into its convs. The JAX package's --to-torch has no
counterpart: the port's weights are torch already.

`train`, `eval` and `serve` wait for the loaders, the Trainer and the
server to be ported (ROADMAP.md, Queue 1 items 2-4) and raise.
"""

from __future__ import annotations

import argparse
import os
import sys


def _export(args) -> int:
    from vision_kit_tpu_torch.export import run_export
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.predictor import load_weights
    from vision_kit_tpu_torch.utils.config import load_config

    cfg = load_config(args.config)
    model = build_model(cfg, device=args.device)
    weights = args.ckpt
    if weights is None:
        weight = getattr(cfg.model, "weight", None)
        weights = str(weight) if weight and os.path.exists(str(weight)) else None
    if weights:
        load_weights(weights, model)
        print(f"loaded weights from {weights}")
    save_dir = os.path.join(args.output_dir or cfg.data.output_dir, "weights")
    result = run_export(cfg, model, save_dir,
                        onnx=True if args.onnx else "auto",
                        torchscript=True if args.torchscript else "auto")
    for kind, path in result.artifacts.items():
        deltas = [v for k, v in result.checks.items() if k.startswith(kind)]
        checked = f" (checked, max |delta| {max(deltas):.2e})" if deltas else ""
        print(f"exported {kind} -> {path}{checked}")
    for kind, reason in result.skipped.items():
        print(f"export {kind} skipped: {reason}")
    return 0


def _convert(args) -> int:
    import torch

    from vision_kit_tpu_torch.convert import (
        load_torch_checkpoint,
        load_upstream_checkpoint,
        reparameterize_v7,
        upstream_to_vision_kit,
    )
    from vision_kit_tpu_torch.models import YOLOV5, YOLOV7
    from vision_kit_tpu_torch.predictor import _merge_counting

    if args.model == "yolov5":
        model = YOLOV5(variant=args.variant, num_classes=args.num_classes)
    else:
        model = YOLOV7(variant=args.variant, num_classes=args.num_classes)
    if args.from_upstream:
        sd = upstream_to_vision_kit(load_upstream_checkpoint(args.weights), model)
    else:
        sd = load_torch_checkpoint(args.weights)
    sd, skipped = _merge_counting(model.state_dict(), sd)
    if skipped:
        raise SystemExit(f"{args.weights} does not cover {args.model} "
                         f"{args.variant}: {skipped} entries missing or "
                         "shape-mismatched")
    if args.reparameterize and args.model == "yolov7":
        sd = reparameterize_v7(sd)
    out = args.output or os.path.splitext(args.weights)[0] + "_port.pt"
    torch.save({"model": sd}, out)
    print(f"converted {args.weights} -> {out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m vision_kit_tpu_torch",
                                     description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="task", required=True)
    exp = sub.add_parser("export", help="checked export of the config's model")
    exp.add_argument("--config", "-c", default="./configs/yolov5.yaml")
    exp.add_argument("--ckpt", help="weights to load (.pt/.pth/.ckpt, or a "
                     "TrainState checkpoint); default cfg.model.weight if it exists")
    exp.add_argument("--output-dir", help="default cfg.data.output_dir")
    exp.add_argument("--onnx", action="store_true",
                     help="require the checked ONNX artifact")
    exp.add_argument("--torchscript", action="store_true",
                     help="require the checked TorchScript trace")
    exp.add_argument("--device", default="cuda")
    conv = sub.add_parser("convert", help="a vision_kit or upstream .pt into "
                          "the port's {'model': state_dict} .pt")
    conv.add_argument("weights", help=".pt/.ckpt file to convert")
    conv.add_argument("--model", "-m", default="yolov5", choices=["yolov5", "yolov7"])
    conv.add_argument("--variant", "-v", default="s")
    conv.add_argument("--num-classes", "-n", type=int, default=80)
    conv.add_argument("--output", "-o")
    conv.add_argument("--from-upstream", action="store_true",
                      help="an upstream ultralytics/WongKinYiu .pt: positional "
                           "zip-map onto the reference's key order")
    conv.add_argument("--reparameterize", action="store_true",
                      help="fold a YOLOv7 head's implicit layers into its convs")
    for task in ("train", "eval", "serve"):
        sub.add_parser(task, help="not ported yet")
    args = parser.parse_args(argv)
    if args.task == "export":
        return _export(args)
    if args.task == "convert":
        return _convert(args)
    raise NotImplementedError(
        f"'{args.task}' is not ported yet: it waits for the image decoder, the "
        "loaders, the Trainer and the server (ROADMAP.md, Queue 1 items 2-4)")


if __name__ == "__main__":
    sys.exit(main())

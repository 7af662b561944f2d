"""Command line of the port: training, evaluation, serving, export and
weight conversion.

    python -m vision_kit_tpu_torch train -c CONFIG [-d CKPT_DIR] [-s SEED] [--device cuda]
    python -m vision_kit_tpu_torch eval -c CONFIG [-d CKPT_DIR] [-s SEED] [--device cuda]

    python -m vision_kit_tpu_torch serve [-m yolov5|yolov7] [-v s] [-w WEIGHTS]
        [-c CONFIG] [--num-classes N] [--labels a,b] [--conf 0.25] [--iou 0.45]
        [--host 127.0.0.1] [--port 8000] [--batch-size 8] [--max-wait-ms 5]
        [--device cuda]

    python -m vision_kit_tpu_torch demo -p IMAGE_DIR_OR_VIDEO [-m yolov5|yolov7] [-v s]
        [-w WEIGHTS] [-c CONFIG] [--num-classes N] [--labels a,b] [--conf 0.25]
        [--iou 0.45] [-o FILE_OR_DIR] [--device cuda]

    python -m vision_kit_tpu_torch export -c CONFIG [--ckpt PATH] [--output-dir DIR]
        [--onnx] [--torchscript] [--device cuda]
    python -m vision_kit_tpu_torch convert WEIGHTS [-m yolov5|yolov7] [-v s]
        [-n 80] [-o OUT] [--from-upstream] [--reparameterize]

`export` is the counterpart of scripts/main.py's export task: the config's
model, its weights from --ckpt (a file, or a JAX Trainer's orbax
ckpts/best or ckpts/last directory: its EMA once updated) or else from
cfg.model.weight when that file exists (predictor.load_weights), written
by export.run_export to
`<output dir>/weights` (the output dir is cfg.data.output_dir unless
--output-dir names another).

`convert` is the counterpart of scripts/convert.py: a vision_kit-format
`.pt`/`.ckpt`, or with --from-upstream a local ultralytics / WongKinYiu
`.pt` zipped by position onto the reference's key order, checked key for
key and shape for shape against the model and written as a
`{"model": state_dict}` `.pt` in f32; --reparameterize folds a YOLOv7
head's implicit layers into its convs. The JAX package's --to-torch has no
counterpart: the port's weights are torch already.

`serve` is the counterpart of scripts/serve.py: the batched HTTP server
(serve.py:InferenceServer) over the model that -m/-v, or --config, name,
with the flags of scripts/demo.py:resolve_model_spec; weights from -w
(predictor.load_weights: a .pt, .ckpt, Flax .msgpack or a JAX Trainer's
orbax checkpoint directory; a YOLOv7 serves deploy-folded), else seeded
ones.

`demo` is the counterpart of scripts/demo.py: the model of -m/-v or
--config (seeded weights unless -w names a .pt, .ckpt, Flax .msgpack or a
JAX Trainer's orbax checkpoint directory).
On images, one warmup on the first image's shape, then one Predictor call
per image of -p (a file, or a directory walked recursively), printing
`<path>: <n> detections in <ms> ms` and writing each image with its
detections drawn (utils/drawing.py:Drawing) as a JPEG: into -o when it is a
directory (utils/readers.py:ImageReader), as -o when -p is one image and -o
a file name (a JPEG, or a PNG, BMP or lossless WebP by its extension),
else beside the input. Any other path is a video
(utils/readers.py:VideoReader): an MP4/QuickTime file, an AVI or a
Matroska file of MPEG-4 Part 2 (cv2's mp4v, XVID, DIVX) or Motion-JPEG,
or VP8 (cv2's VP80) or VP9 profile 0 (cv2's VP90) in WebM, Matroska, AVI,
IVF or MP4, one Predictor call per frame on the frame as decoded and converted to RGB
on the device, printing `frame <n>: <ms> ms (<fps> fps avg)` every 30
frames and the average at the end, and with -o writing the drawn frames
as mp4v, as the JAX demo writes them, into the container the name gives:
MP4 for .mp4/.mov, AVI for .avi, Matroska for .mkv (a .webm raises:
WebM takes no mp4v). A webcam index, AV1, H.264/HEVC, the MPEG-4 tools
outside Simple Profile and the VP9 the port refuses (profiles 1-3, scaled
references, a change of size, colour matrices other than BT.601) raise
naming themselves. A .bmp output is written as cv2.imwrite writes it; a
.webp output is lossless VP8L (data/encode.py:encode_webp), as cv2.imwrite
writes by default, but with the port's own encoder choices, so its bytes
differ while its pixels are the same.

`train` and `eval` are the counterparts of scripts/main.py's tasks: the
seed is --seed, else the config's data.seed, else 21; --deterministic
(train) sets CUBLAS_WORKSPACE_CONFIG=:4096:8 before CUDA starts and runs
Trainer(deterministic=True), whose runs from one seed repeat bit for bit;
the run writes into
<cfg.data.output_dir>/<model>/<task>/<YYYYmmddHHMM> (log.log, ckpts/,
weights/, the sample grids), with the loss gains scaled by
update_loss_cfg. `train` runs Trainer.fit (resuming from <ckpt-dir>/last
when -d is given and it exists), then Trainer.test; `eval` loads
<ckpt-dir>/best when it exists, then runs Trainer.test. <ckpt-dir> is a
run's ckpts/, the port's or a JAX run's: orbax directories either way
(read by utils/orbax.py without orbax or tensorstore; the resume
continues at the saved step), or an earlier port run's torch.save files. The loader takes
the host-augmentation route unless the config sets data.device_aug: true.
Both call parallel/distributed.py:init_distributed first, so that

    torchrun --nproc_per_node N -m vision_kit_tpu_torch train -c CONFIG

trains data-parallel on N cards (one process each, NCCL; gloo with
--device cpu), the global batch being the config's; rank 0 names the run
directory and alone writes into it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def resolve_model_spec(args):
    """model/variant/num_classes/labels/img_size from -m/-v defaults,
    --config, and the --num-classes/--labels overrides: the port's copy of
    scripts/demo.py:resolve_model_spec."""
    from vision_kit_tpu_torch.classes import COCO

    model_name, variant = args.model, args.variant
    num_classes, labels, img_size = 80, list(COCO), (640, 640)
    if args.config:
        from vision_kit_tpu_torch.utils.config import load_config

        cfg = load_config(args.config)
        model_name = "yolov7" if "7" in str(cfg.model.name) else "yolov5"
        variant = str(cfg.model.version)
        num_classes = int(cfg.model.num_classes)
        labels = list(cfg.data.class_labels)
        img_size = tuple(cfg.model.input_size)
    if args.num_classes is not None:
        num_classes = args.num_classes
        if len(labels) != num_classes:
            labels = [str(i) for i in range(num_classes)]
    if args.labels is not None:
        labels = [s.strip() for s in args.labels.split(",") if s.strip()]
        if args.num_classes is None:
            num_classes = len(labels)
    return model_name, variant, num_classes, labels, img_size


def _spec_predictor(args):
    """(Predictor, labels, model name, variant, img_size) of the model that
    -m/-v or --config name (resolve_model_spec), with -w's weights or
    seeded ones; a YOLOv7 is built deploy-folded, as scripts/demo.py loads
    it."""
    from vision_kit_tpu_torch.predictor import load_predictor_from_config
    from vision_kit_tpu_torch.utils.config import load_config

    model_name, variant, num_classes, labels, img_size = resolve_model_spec(args)
    cfg = load_config(os.path.join(REPO, "configs", f"{model_name}.yaml"))
    cfg.model.version, cfg.model.num_classes = variant, num_classes
    cfg.model.input_size = list(img_size)
    if model_name == "yolov7":
        cfg.model.deploy = True
    predictor = load_predictor_from_config(
        cfg, weights=args.weights, device=args.device,
        conf_thres=args.conf, iou_thres=args.iou)
    return predictor, labels, model_name, variant, img_size


def demo_images(predictor, drawer, path: str, output: str | None = None) -> list:
    """scripts/demo.py's image mode: every image under `path` through
    `predictor` (one warmup on the first image's shape, then one call per
    image), printed and written with its detections drawn. Returns
    [(image path, detections (n, 6) or None when it could not be read,
    written path or None)]."""
    from vision_kit_tpu_torch.data.decode import encode_bmp, encode_png
    from vision_kit_tpu_torch.data.encode import encode_jpeg, encode_webp
    from vision_kit_tpu_torch.utils.readers import IMAGE_EXT, ImageReader

    # -o: an exact file name for a single image, a directory otherwise
    single_file_out = (output if output and not os.path.isdir(path)
                       and output.lower().endswith(IMAGE_EXT) else None)
    encoder = None
    if single_file_out:
        ext = os.path.splitext(single_file_out)[1].lower()
        encoder = {".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".png": encode_png,
                   ".bmp": encode_bmp, ".webp": encode_webp}[ext]   # IMAGE_EXT, each
    reader = ImageReader(path, save_path=(None if single_file_out else output) or (
        path if os.path.isdir(path) else os.path.dirname(path) or "."),
        device=predictor.device)
    out, warm = [], False
    for (ok, rgb), file in zip(reader, reader.files):
        if not ok:
            print(f"cannot read {file}", flush=True)
            out.append((file, None, None))
            continue
        if not warm:
            predictor.warmup(rgb.shape[:2])
            warm = True
        dets, ms = predictor(rgb)
        print(f"{file}: {len(dets)} detections in {ms:.2f} ms", flush=True)
        drawn = drawer.draw(rgb, dets)
        if single_file_out:
            parent = os.path.dirname(single_file_out)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(single_file_out, "wb") as f:
                f.write(encoder(drawn))
            written = single_file_out
        else:
            written = reader.save(drawn, file)
        print(f"saved {written}", flush=True)
        out.append((file, dets, written))
    return out


def demo_video(predictor, drawer, path: str, output: str | None = None,
               show: bool = False) -> dict:
    """scripts/demo.py's video mode on a video file (VideoReader: AVI,
    MP4/QuickTime, Matroska/WebM, IVF, YUV4MPEG2 or raw Motion-JPEG, holding
    MPEG-4 Part 2, Motion-JPEG, VP8, VP9, PNG, Motion JPEG 2000 or raw
    video; a file cv2 reads no frame from runs no frame): one predictor call per
    frame (the frame as decoded on the predictor's device), its detections
    drawn on the host, and with `output` the drawn frame appended as mp4v
    (in an MP4 for .mp4/.mov, an AVI for .avi, Matroska for .mkv). Prints `frame <n>: <ms> ms (<fps> fps
    avg)` every 30 frames and `avg <ms> ms/frame over <n> frames` at the
    end. `show` is accepted for scripts/demo.py's flag; the port opens no
    window. Returns {"detections": [(n, 6) per frame], "fps": the input's,
    "ms": {"read", "predict", "draw", "encode": per-frame host-clock ms},
    "wall_s"}: "read" is the wait for the next decoded frame, "predict"
    the predictor's own time."""
    from vision_kit_tpu_torch.utils.readers import VideoReader

    reader = VideoReader(path, save_path=output, device=predictor.device)
    stages = {"read": [], "predict": [], "draw": [], "encode": []}
    dets_by_frame, total_ms = [], 0.0
    t_start = time.perf_counter()
    frames = iter(reader)
    try:
        while True:
            t0 = time.perf_counter()
            ok, rgb = next(frames)
            t1 = time.perf_counter()
            if not ok:
                break
            dets, ms = predictor(rgb)
            t2 = time.perf_counter()
            drawn = drawer.draw(rgb.cpu().numpy(), dets)
            t3 = time.perf_counter()
            if output:
                reader.save(drawn)
            t4 = time.perf_counter()
            for name, a, b in (("read", t0, t1), ("draw", t2, t3), ("encode", t3, t4)):
                stages[name].append((b - a) * 1000)
            stages["predict"].append(ms)
            dets_by_frame.append(dets)
            total_ms += ms
            n = len(dets_by_frame)
            if n % 30 == 0:
                print(f"frame {n}: {ms:.1f} ms ({1000 * n / total_ms:.1f} fps avg)",
                      flush=True)
    finally:
        reader.stop()
    n = len(dets_by_frame)
    if n:
        print(f"avg {total_ms / n:.2f} ms/frame over {n} frames", flush=True)
    return {"detections": dets_by_frame, "fps": reader.fps, "ms": stages,
            "wall_s": time.perf_counter() - t_start}


def _demo(args) -> int:
    from vision_kit_tpu_torch.utils.drawing import Drawing
    from vision_kit_tpu_torch.utils.readers import IMAGE_EXT

    predictor, labels, *_ = _spec_predictor(args)
    if os.path.isdir(args.path) or args.path.lower().endswith(IMAGE_EXT):
        demo_images(predictor, Drawing(labels), args.path, args.output)
    else:
        demo_video(predictor, Drawing(labels), args.path, args.output, args.show)
    return 0


def _serve(args) -> int:
    from vision_kit_tpu_torch.serve import InferenceServer

    predictor, labels, model_name, variant, img_size = _spec_predictor(args)
    server = InferenceServer(
        predictor, class_labels=labels, batch_size=args.batch_size,
        max_wait_ms=args.max_wait_ms, host=args.host, port=args.port)
    print(f"warming up the serving shape (batch={args.batch_size}, "
          f"img={img_size}) ...", flush=True)
    server.start()
    print(f"serving {model_name}-{variant} on http://{args.host}:{server.port}"
          f"  (POST /predict, GET /healthz, GET /stats)", flush=True)
    server.wait()  # blocks; KeyboardInterrupt shuts down cleanly
    return 0


def _train_or_eval(args) -> int:
    if getattr(args, "deterministic", False):
        # before anything starts CUDA: cuBLAS reads it once
        from vision_kit_tpu_torch.utils.general import CUBLAS_WORKSPACE_CONFIG

        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE_CONFIG
    import torch

    from vision_kit_tpu_torch.parallel import init_distributed

    on_cpu = torch.device(args.device).type == "cpu"
    distributed = init_distributed(backend="gloo" if on_cpu else None)
    try:
        return _run_task(args, distributed)
    finally:
        if distributed:
            torch.distributed.destroy_process_group()


def _run_task(args, distributed: bool) -> int:
    import logging

    import numpy as np

    from vision_kit_tpu_torch.parallel import mesh as pmesh
    from vision_kit_tpu_torch.train.evaluator import DetEvaluator
    from vision_kit_tpu_torch.train.trainer import Trainer
    from vision_kit_tpu_torch.utils.config import load_config
    from vision_kit_tpu_torch.utils.general import (
        mk_output_dir,
        resolve_device,
        update_loss_cfg,
    )
    from vision_kit_tpu_torch.utils.logging_utils import logger, setup_logger

    device = resolve_device(args.device)
    mesh = pmesh.make_mesh(device=device) if distributed else None
    main = mesh is None or mesh.is_main
    cfg = load_config(args.config)
    seed = args.seed
    if seed is None:
        cfg_seed = getattr(cfg.data, "seed", None)
        seed = int(cfg_seed) if cfg_seed is not None else 21
    np.random.seed(seed)
    out = mk_output_dir(cfg.data.output_dir, cfg.model.name, args.task) if main else None
    cfg.data.output_dir = out if mesh is None else pmesh.broadcast_object(mesh, out)
    if main:
        setup_logger(cfg.data.output_dir)
    else:
        setup_logger(level=logging.WARNING)
    logger.info("Global seed set to %d", seed)
    cfg = update_loss_cfg(cfg)
    evaluator = DetEvaluator(class_labels=list(cfg.data.class_labels),
                             img_size=tuple(cfg.model.input_size),
                             gt_json=getattr(cfg.data, "gt_json", None))
    ckpt_path = None
    if args.ckpt_dir:
        ckpt_path = os.path.join(args.ckpt_dir, "last" if args.task == "train" else "best")
        if not os.path.exists(ckpt_path):
            logger.info("no checkpoint at %s: starting fresh", ckpt_path)
            ckpt_path = None
    trainer = Trainer(cfg, evaluator=evaluator, seed=seed, device=device, mesh=mesh,
                      deterministic=getattr(args, "deterministic", False))
    if args.task == "train":
        logger.info("Start Training...")
        trainer.fit(resume=ckpt_path)
    elif ckpt_path:
        trainer.load_checkpoint(ckpt_path)
    trainer.test()
    return 0


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
    exp.add_argument("--ckpt", help="weights to load (.pt/.pth/.ckpt, a "
                     "TrainState checkpoint, a Flax .msgpack or a JAX Trainer's "
                     "orbax checkpoint directory); default cfg.model.weight if "
                     "it exists")
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
    demo = sub.add_parser("demo", help="detections drawn on images")
    demo.add_argument("--path", "-p", required=True,
                      help="an image, a directory of images, or a video (.mp4/.mov, or "
                           ".avi or .mkv of MPEG-4 Part 2 or Motion-JPEG)")
    demo.add_argument("--model", "-m", default="yolov5", choices=["yolov5", "yolov7"])
    demo.add_argument("--variant", "-v", default="s")
    demo.add_argument("--weights", "-w", default=None)
    demo.add_argument("--config", "-c", default=None,
                      help="training config YAML: model/classes/img-size/labels read "
                           "from it")
    demo.add_argument("--num-classes", type=int, default=None)
    demo.add_argument("--labels", default=None, help="comma-separated class names")
    demo.add_argument("--conf", type=float, default=0.25)
    demo.add_argument("--iou", type=float, default=0.45)
    demo.add_argument("--output", "-o", default=None,
                      help="output directory, or a file name for a single image "
                           "(.jpg, .png, .bmp or .webp), or for a video an .mp4, .mov, .avi "
                           "or .mkv (mp4v in each); default beside the input (images) or "
                           "none (video)")
    demo.add_argument("--show", action="store_true",
                      help="accepted for scripts/demo.py's flags; the port opens no "
                           "window")
    demo.add_argument("--device", default="cuda")
    srv = sub.add_parser("serve", help="batched HTTP inference server")
    srv.add_argument("--model", "-m", default="yolov5", choices=["yolov5", "yolov7"])
    srv.add_argument("--variant", "-v", default="s")
    srv.add_argument("--weights", "-w", default=None)
    srv.add_argument("--config", "-c", default=None,
                     help="training config YAML: model/classes/img-size read from it")
    srv.add_argument("--num-classes", type=int, default=None)
    srv.add_argument("--labels", default=None, help="comma-separated class names")
    srv.add_argument("--conf", type=float, default=0.25)
    srv.add_argument("--iou", type=float, default=0.45)
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8000)
    srv.add_argument("--batch-size", type=int, default=8,
                     help="serving batch (one fixed shape; partial batches are padded)")
    srv.add_argument("--max-wait-ms", type=float, default=5.0,
                     help="max dispatcher wait for batch coalescing after the "
                          "first request arrives")
    srv.add_argument("--device", default="cuda")
    for task, what in (("train", "Trainer.fit, then Trainer.test"),
                       ("eval", "Trainer.test of <ckpt-dir>/best")):
        p = sub.add_parser(task, help=what)
        p.add_argument("--config", "-c", default="./configs/yolov5.yaml")
        p.add_argument("--ckpt-dir", "-d", default=None,
                       help="train: resume from <dir>/last; eval: load <dir>/best "
                            "(the port's checkpoint files or a JAX run's orbax "
                            "directories)")
        p.add_argument("--seed", "-s", type=int, default=None,
                       help="default: the config's data.seed, else 21")
        p.add_argument("--device", default="cuda")
        if task == "train":
            p.add_argument("--deterministic", action="store_true",
                           help="deterministic algorithms on the card "
                                "(Trainer(deterministic=True)): runs from one seed "
                                "repeat bit for bit, at a cost in speed")
    args = parser.parse_args(argv)
    if args.task in ("train", "eval"):
        return _train_or_eval(args)
    if args.task == "demo":
        return _demo(args)
    if args.task == "export":
        return _export(args)
    if args.task == "convert":
        return _convert(args)
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())

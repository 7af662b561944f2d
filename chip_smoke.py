#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vision_kit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: builds every CUDA source in csrc/ (one nvcc each, in parallel)
     and prints each kernel's registers, shared memory and spills; TF32 off
     for the f32 comparisons;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at both serving paths' shapes (greedy NMS bit-equal at K up
     to 2048, head scores in bf16, f16 and f32 with ragged tiles, and
     anchor-major at b128, b8 over four inputs and ragged tiles), one
     launch counted per call;
  4. main path: YOLOv5s (80 classes, 640, bf16, seeded random weights)
     behind Predictor.predict_batch for 3 requests of 8 720x1280 frames,
     with the kernels' launch counts read around it; detections equal those
     of the same program on the plain versions, and an f32 model on the card
     agrees with the same model on the CPU on a small input; then the
     median and p99 request latency over 200 requests;
  5. throughput: run_detector_bench for v5s@640, batch 128, bf16, on the
     calibrated head and on the seeded random head as built;
  6. eval path: the phase-4 model behind make_eval_step (the eval
     protocol) and trainer.validate over 4 batches of 64 seeded 640x640
     frames in ValLoader's format, ground truth from a first pass; with
     the kernel against the plain keep (detections and metrics equal, one
     greedy_nms launch a batch, no head_scores launch), an f32 v5s@128 eval
     on the card against the CPU, trainer.test's COCO metric set,
     run_eval_bench at batch 64 (img/s and the evaluator's host ms a batch),
     and topk_stable's two routes: the order of ties on the card against a
     stable argsort, and each route's time beside torch.topk at every top-k
     of both postprocesses;
  7. YOLOv7: v7 base@640 (80 classes) built in the training structure in
     f32, head calibrated through the implicit layers, folded by
     convert.deploy_state_dict into a deploy model whose decoded output
     equals the training structure's to 2e-3 (both structures' raw maps
     pass head_scores' layout check); the deploy model in bf16 behind
     Predictor.predict_batch for 3 requests of 8 720x1280 frames (both
     kernels launched, detections equal to the plain versions'), and with
     multi_label for one; an f32 v7 base@128 on the card against the CPU;
     request latency over 100 requests; run_detector_bench and
     run_eval_bench at batch 64 in bf16;
  8. train: make_train_step on v5s@640 (f32 parameters, bf16 autocast,
     YoloLoss, batch 64, tools/bench_train.py's batch and hyperparameters)
     for 20 steps on one batch, whose loss must fall; the EMA model through
     make_eval_step on a batch of 64 (one greedy_nms launch, detections
     equal to the plain keep's); run_train_bench plain, with device
     augmentation, accum_steps=2 and remat (which must lower the peak
     memory), and warp_augment's time alone; v7 base@640 in the training
     structure with YoloLossOTA at batch 16 for 10 steps (the loss falls)
     and run_train_bench; an f32 v5n@128 step on the card against the CPU
     and the OTA loss on the same v7 base@128 maps on both; the EMA eval
     runs in bf16 (autocast over the f32 EMA tree);
  9. weights: the phase-4 model written as a plain .pt, a Lightning
     checkpoint (EMA beside stale weights) and an upstream-ordered .pt
     (zipped back by convert.upstream_to_vision_kit), and a TrainState
     after two v5s training steps, each loaded by
     load_predictor_from_config on the card: 3 requests of 8 720x1280
     frames give detections equal to the in-memory model's (the EMA model
     for the TrainState), each kernel launched once a request;
     load_weights timed once; v7 base training weights loaded into a deploy
     model (folded on load) equal to the in-memory fold in f32; the same
     v5s weights in a decode_order="reference" model behind Predictor,
     launching the anchor-major head_scores and greedy_nms, its detections
     equal to the native order's and to the plain versions', and its
     request latency in turns with the native order's; run_export of
     v5s@640 in f32 on the card, each artifact's check or skip printed,
     and its Flax msgpack served by load_predictor_from_config: detections
     bit-equal to the in-memory model's;
 9b. demo: python -m vision_kit_tpu_torch demo on the committed samples in
     a child process, the phase-4 weights handed over as a Flax msgpack:
     one JPEG per sample the port decodes (the progressive JPEG, the BMPs
     and the WebPs among them), each printed count equal to an in-process
     Predictor's; then the video mode on a Motion-JPEG AVI of
     the 720x1280 samples (12 frames at 30 fps; demo -p clip.avi -o
     out.avi in a child, --demo-video): VideoReader's frames against the
     plain decoder (bit-equal) and nvJPEG (within its tolerance), threaded
     against unthreaded, each frame's detections equal to an in-process
     Predictor's, one launch of each kernel a frame, out.avi mp4v as the
     JAX writer writes it (handler and biCompression mp4v), every chunk
     Mp4vEncoder's VOP of the drawn frame, read back as its
     reconstruction, the ms a frame by stage; and one sample's -o .webp
     output (lossless VP8L, encode_webp)
     read back bit-equal to its -o .bmp output's drawn frame; then MPEG-4
     Part 2 (mp4_leg): the committed mp4v clips through the host C++
     decoder (csrc/mpeg4_decode.cu) at cv2's sha256 on every frame and
     bit-equal to the plain decoder on the small clip and the 720p clip's
     first GOP, and demo -p mp4v_720x1280_24f.mp4 -o out.mp4 in a
     --demo-video child: one launch of each kernel a frame (the *_video
     rows count the six video runs), detections equal to an in-process
     Predictor's, out.mp4 Mp4vEncoder's VOPs, read back as its
     reconstruction; then Matroska (mkv_leg): the committed cv2-written
     720p mp4v .mkv through VideoReader (utils/mkv.py, the C++ decoder) at
     cv2's sha256 on every frame, the XviD-tagged AVI through the C++
     decoder's XviD IDCT at cv2's sha256, the V_MJPEG .mkv through nvJPEG
     within its tolerance, the demux ms a frame and the C++ decoder's ms
     with either IDCT, and demo -p mp4v_720x1280_24f.mkv -o out.mkv in a
     --demo-video child, checked as the mp4 run, out.mkv's CodecPrivate
     the encoder's VOL (its seconds in `seconds by phase:`); then VP8
     (vpx_leg): the committed cv2-written VP8 .webm clips through the host
     C++ decoder (csrc/vp8_decode.cu) at cv2's sha256 on every frame (the
     720p one through VideoReader too), bit-equal to the plain decoder on
     the small clip, the ms a 720p key and inter frame, and demo -p
     vp8_720x1280_12f.webm (no -o) in the same --demo-video child: one
     launch of each kernel a frame, detections equal to an in-process
     Predictor's (its seconds in `seconds by phase:`); then VP9 (the same
     vpx_leg): the committed cv2-written VP9 .webm clips (the 720p one in
     four tile columns) through csrc/vp9_decode.cu the same way, and demo
     -p vp9_720x1280_12f.webm (no -o) as a fifth run of that child; then
     the tags and containers of these codecs (tags_leg): every fixture of
     data/video_samples/tags/ (cv2's Motion-JPEG in MP4, QuickTime, a JPGL
     AVI and a raw .mjpeg, XVID in QuickTime, PNG and Motion JPEG 2000
     frames in AVI, Matroska, MP4 and QuickTime, raw I420, Y800 and RGBA
     in AVI, Matroska, QuickTime and YUV4MPEG2, a UYVY AVI of no frame)
     through VideoReader on the card, threaded and unthreaded, at cv2's
     count and fps, bit-equal to the plain CPU read (nvJPEG within its
     tolerance) and that read at the manifest's sha256, the Motion JPEG
     2000 frames by the C++ twin's video mode, each file's route and
     seconds; and demo -p mjp2_64x96.mov (no -o) as a sixth run of that
     child: one launch of each kernel a frame;
 10. serve: nvJPEG's header, library and version; each sample of
     vision_kit_tpu_torch/data/samples/ decoded on the card by the route
     its header and the host C walk pick (decode.decode_route: nvJPEG for
     a baseline or complete progressive JPEG whose scans hold every bit;
     the host decoder uploaded for a progressive JPEG that ends early, a
     CMYK, YCCK or RGB JPEG, an arithmetic-coded ("host_arith") or
     lossless ("host_lossless") JPEG, a PNG, a BMP, and each kind of
     data/<kind>.py on its own route: WebP, GIF, HDR, Sun raster,
     Netpbm/PAM, PFM, TIFF) against the plain decoder on the host (nvJPEG
     within decode.NVJPEG_TOLERANCE; a host route decodes once on the host
     and its frame reaches the card unchanged; each sample of those kinds
     and each arithmetic-coded and lossless JPEG at its manifest's
     rgb_sha256, EXIF shapes equal, the truncated
     samples and the frames cv2 refuses (grey lossless, 12-bit, SOF11)
     refused on both); the 720x1280 frame without its EOI on "host_cut",
     bit-equal to the plain decoder and to the whole file, never on
     nvJPEG, and 5 bytes short refused on both; the C walk
     (csrc/jpeg_walk.cu) equal to scans_short on every JPEG sample and its
     cut versions, its host ms on the 720p baseline and progressive
     frames; JPEGs without Huffman tables (a 720p frame with no DHT, one
     with an optimised slot 0 and no slot 1) on "nvjpeg" with the standard
     tables spliced in, within NVJPEG_TOLERANCE, nvJPEG's answer to the
     bytes as they are, their reduced decodes equal to the spliced file's,
     their nvJPEG ms, and a Motion-JPEG AVI of the 720p frames without
     DHTs through VideoReader (nvJPEG) to its last frame; a baseline and a progressive sample cut inside their last
     scan on "host_cut", bit-equal to the plain decoder; a 40000x40000 SOF
     refused before nvJPEG; the count of each route, one 720x1280
     progressive decode timed by nvJPEG and by the plain decoder beside
     the baseline frame's, the plain WebP decode at 240x320 lossy and
     lossless, the plain decode of the 117x163 arithmetic-coded and
     lossless JPEGs, each data/<kind>.py route's count and the plain
     decode of each of its samples (the 720x1280 GIF and LZW TIFF with
     predictor 2 among them) and of a 720x1280 TIFF of LZW literal codes
     only; a scan naming an undefined Huffman table stopped at the
     walk, a component naming an undefined quantization table refused by
     nvJPEG and the next decode equal to the first; letterbox_u8 bit-equal on the
     card and the CPU; the synchronising calls of one Predictor.run; the
     phase-4 model behind InferenceServer (batch 8, max_wait 5 ms): 64
     engine requests equal Predictor.run on the same device-decoded
     frames (class exact, score 1e-5, box 1e-3 px), 64 POSTs from 16
     clients of every decodable sample but one of each still-image kind
     other than WebP (progressive JPEGs, BMPs and WebPs among them) equal
     it within the JSON's rounding with each kernel launched
     once a batch, a garbage body answered 400; then utils/serve_bench.py:
     the engine over the decoded samples, HTTP from 32 clients beside one
     request's decode alone, the same JPEG load for 10 s alone and beside
     one more client POSTing the 2048x2048 lossy WebP in a loop (its decode
     in the server's worker processes; path_turns.http_contention), a load
     curve at 0.5, 0.8 and 0.95 of the engine's capacity, and the engine
     with synthetic_ingest 4 at batch 8 and 64;
 11. fit: utils/loader_bench.py:write_dataset's YOLO dataset (the samples
     under several names, the progressive JPEGs, BMPs, JPEGs without
     Huffman tables and two WebPs kept by the scan, PNG rectangle scenes,
     the three truncated 240x320 samples restored in place by the scan to
     their manifest's restored_sha256, the bytes the JAX package writes)
     through Trainer.fit for v5s@640 bf16, 2 classes, 2 epochs at batch 64
     with configs/yolov5_tpu.yaml's device augmentation and RAM cache on
     the card, then test(): one greedy_nms launch per validation batch and
     none of head_scores; the run directory as the JAX Trainer writes it:
     ckpts/last and ckpts/best orbax directories (last read back on the
     card equal to the state's JAX tree bit for bit), written in the
     background (the Trainer's blocked ms a save and the writer's ms),
     train.jpg and val.jpg decoding, the best weights a Flax msgpack equal
     to ckpts/best's f32 EMA, served by load_predictor_from_config with a
     launch of each kernel; the card's TrainLoader and ValLoader
     against a CPU dataset's (loader_bench.loader_disagreements); a twin
     run's distance in the default mode; decoder "plain" on the card: the
     host route's batches of 8 bit-equal with 0 and 8 workers;
     YOLODataset(fast_decode=True) at 640, 320 and 160 (a 720x1280 sample
     reduced at 1/2, 1/4, 1/8, the progressive files too): items on the
     card bit-equal to the CPU's,
     and the ms an image of the reduced and the full plain decode and of
     nvJPEG plus resize_u8; in a child
     process (--deterministic-check), two Trainer(deterministic=True)
     fits bit-identical, a deterministic crash after step 3
     resumed from ckpts/last (an orbax directory), bit-identical to an
     uninterrupted run, and the
     step alone in both modes; the train CLI as a subprocess; an
     epoch under the profiler and the sample grid alone; the
     loader's rates and ms a batch, and the step alone on the fit's model;
 12. fit-host: the repo's default config, configs/yolov5.yaml, as it stands
     (v5s@640 bf16, batch 8, 8 spawned workers, no image cache, no
     data.device_aug: the host-augmentation route) but for its data and
     output dirs (write_dataset's files), 2 classes, 2 epochs, and degrees
     5 and shear 2, so that the rotation/shear warp runs: Trainer.fit (16
     steps an epoch; img/s and the loader's wait share by epoch; one
     greedy_nms launch per validation batch and none of head_scores;
     ckpts/last an orbax directory), then test(); each op of
     ops/imgproc.py on the card against the CPU, bit for bit, on a seeded
     640 and 1280 image (the warp under rotation, shear
     and translation, HSV at three gain draws, blur, median, gray, Lab,
     CLAHE, the pad); two host-route TrainLoader batches of 8 with mixup
     from a PNG-only dataset on the card (num_workers 0: every op on the
     card) against the same files on the CPU, images and targets bit-equal;
     the host route's img/s with its thread and its ms a batch alone, and
     its img/s with 8 workers in the steady state, at b8 (b64, a round of
     about a minute, is left out to keep the script inside its limit);
 13. ddp: data parallelism (vision_kit_tpu_torch/parallel/) in child
     processes, with cuDNN. A world of 1 over NCCL through
     init_distributed: a v5s@640 b64 step under the mesh against the same
     step without it, in float64 and in f32 (mesh_step_failures), and the
     bf16 step's img/s with and without the mesh, once each. Two ranks
     sharing the card over gloo on CUDA tensors: the 2x32 step against
     the 1x64 step likewise, the f32 one held to each rank's rows run
     alone; the bf16 2x32 step's time; Trainer.fit (the fit phase's
     config and files, 32 rows a rank) whose ranks end bit-identical with
     one greedy_nms launch a rank per validation batch, each rank finding
     rank 0's ckpts/last an orbax directory as fit returns; the 2-rank
     validation against rank 0's alone over whole batches (the same
     detections, then the metrics to 1e-9); then on the same two ranks the
     main path's v5s@640 bf16 behind Predictor(mesh=...): 8 frames of
     720x1280 (4 a rank) and 3 (every rank runs them whole), each rank's
     rows bit-equal to the same rows run alone, rank 0's against one
     process at b8, one launch of each kernel a rank a request, the
     request latency; and InferenceServer over the mesh Predictor (rank 0
     binds HTTP, rank 1 follows) answering each committed sample JPEG as a
     one-process server at batch 4 does (the rows rank 0 runs);
 14. spatial: the mesh's model axis (parallel/spatial.py) on two ranks
     sharing the card over gloo as a 1x2 mesh, in child processes
     (--spatial-rank): Predictor(spatial=True) on v5s@640 bf16 against one
     process, InferenceServer over it, the v5s@640 spatial train step
     against the unsharded one in float64 and f32, v7 base@128's spatial
     eval step (a halo taller than a band) against unsharded (see
     phase_spatial);
 15. orbax (run after the weights phase): the JAX Trainer's orbax
     checkpoints without orbax, tensorstore or zstandard (utils/zstd.py,
     utils/ocdbt.py, utils/orbax.py): the host C decoder
     (csrc/zstd_decode.cu) on the committed frames and checkpoints of
     data/checkpoint_samples (OCDBT with a multi-level B-tree, and the
     plain layout), byte-equal to the plain decoder and to the manifest's
     sha256, and its MB/s on the largest frame; a v5s@640 TrainState after
     two steps (momentum, EMA) written as the JAX Trainer's tree by
     write_checkpoint and read back by read_checkpoint on the card's path,
     every leaf bit-equal (MB, write and read seconds), and the same state
     through the Trainer's AsyncCheckpointer (the caller's blocked ms, the
     writer's ms), read back bit-equal; one b8 640 batch
     served through load_predictor_from_config of that directory and of
     the port's own file of the same state, detections bit-equal with both
     kernels launched; in a child (--orbax-resume, deterministic),
     Trainer.load_checkpoint of each followed by one train step, the
     states bit-equal, the step and meta carried;
then each kernel timed at the serving and eval paths' shapes beside the
plain version and the card's bound (utils/kernel_bench.py), and the device
time of a throughput step and of an eval step, v5s and v7, by kernel group
with the idle share and the convolutions' bound (profiler), and of three
training steps (v5s, v5s with device augmentation, v7 with SimOTA) by
kernel group and by the step's profiler ranges. Then one JSON line with
each kernel's numbers, a row for each path's shape (greedy_nms_eval is the
greedy-NMS kernel at the eval step's shape, with the eval path's launches;
greedy_nms_train_eval the same shape with the launches of the EMA model's
eval step; head_scores_v7 and greedy_nms_v7 the kernels at v7's b64 serving
shape, with the v7 throughput run's launches; head_scores_anchor_major the
kernel on a reference-order head's b128 maps, with the reference-order
serving run's launches; greedy_nms_serve and head_scores_serve the kernels
at the server's batch 8, K=1024, with the launches of the server's HTTP
run; greedy_nms_fit the eval shape with the launches of fit's
validations; greedy_nms_ddp a rank's share of it, B=32, with rank 0's
launches in the ddp phase's fit and both ranks' under launches_by_rank;
greedy_nms_mesh_serve and head_scores_mesh_serve the kernels at a rank's
share of a mesh serving batch, B=4, K=1024, with rank 0's launches in the
mesh server's HTTP run and both ranks' under launches_by_rank;
greedy_nms_spatial and head_scores_spatial the kernels at a spatial
single-frame request's B=1, K=1024, with rank 0's launches in one such
request and both ranks' under launches_by_rank; greedy_nms_video and
head_scores_video the same B=1 shape, with the launches of the demo's
six video runs, the Motion-JPEG AVI's, the mp4v .mp4's and .mkv's, the
VP8 and VP9 .webm's and the Motion JPEG 2000 .mov's, summed)
and, last, {"ok": true,
"device": ...}.

The main path's head has its biases zeroed and its kernels scaled to unit
logit spread (from a probe batch), so that seeded random weights yield
crowded detections instead of none: every frame then fills max_det, a load
at saturation that is heavier on the postprocess than a trained detector's.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOP_S = 989e12    # bf16 tensor cores, dense, H100 SXM
NMS_KS = (252, 512, 1024, 1280, 2048)
NMS_CHECK_CASES = ("random", "crowded", "invalid_tail", "all_invalid")
HEAD_CHECK_SHAPES = (
    (128, ((80, 80), (40, 40), (20, 20))),   # throughput path, v5s@640
    (64, ((80, 80), (40, 40), (20, 20))),    # throughput path, v7 base@640
    (8, ((80, 80), (40, 40), (20, 20))),     # request path, v5s@640
    (4, ((80, 80), (40, 40), (20, 20))),     # a rank's share of a mesh request
    (1, ((80, 80), (40, 40), (20, 20))),     # a spatial request's gathered maps
    (1, ((5, 5), (7, 3), (1, 1))),           # ragged last tiles
)
# anchor-major head scores: (batch, grids, distinct inputs), as kernel_bench
# times them (b8 rotates four inputs)
ANCHOR_MAJOR_CHECKS = (
    (128, ((80, 80), (40, 40), (20, 20)), 1),
    (8, ((80, 80), (40, 40), (20, 20)), 4),
    (1, ((5, 5), (7, 3), (1, 1)), 1),
)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def build_kernels() -> None:
    """Build every csrc/*.cu at once (one nvcc each, in parallel) and print
    each kernel's registers, shared memory and spills from ptxas."""
    from concurrent.futures import ThreadPoolExecutor

    from vision_kit_tpu_torch import _cuda_build

    names = sorted(f[:-3] for f in os.listdir(_cuda_build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_cuda_build.build, names))
    print(f"build: {', '.join(n + '.cu' for n in names)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, lib in zip(names, libs):
        kernel, info = None, {}
        with open(lib + ".log") as f:
            for line in f:
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1]
                    info[kernel] = []
                elif kernel and ("registers" in line or "spill" in line):
                    info[kernel].append(line.split(":", 1)[-1].strip()
                                        if "registers" in line else line.strip())
        for kernel, lines in info.items():
            short = next((w for w in ("nms_mask_kernel", "nms_walk_kernel",
                                      "head_scores_kernel") if w in kernel), kernel)
            if short == "head_scores_kernel":
                dtype = ("bf16" if "bfloat16" in kernel else
                         "f16" if "__half" in kernel else "f32")
                short += f"<{dtype}{', masked' if 'Lb1E' in kernel else ''}>"
            print(f"build: {name}.cu {short}: {'; '.join(lines)}", flush=True)


def phase_kernels(rng):
    from vision_kit_tpu_torch.ops.boxes import box_iou_pairwise
    from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep, greedy_keep_reference
    from vision_kit_tpu_torch.ops.head_scores import head_scores, head_scores_reference
    from vision_kit_tpu_torch.utils import kernel_bench as kb

    # -- greedy NMS: bit-equal masks (B=32: a rank's share of the eval
    # batch; B=1: a spatial request)
    for b in (1, 4, 8, 32, 64, 128):
        for k in NMS_KS:
            for case in NMS_CHECK_CASES:
                boxes, valid = kb.make_boxes(rng, b, k, case)
                before = greedy_keep.launches
                got = greedy_keep(boxes, valid, kb.IOU)
                check(greedy_keep.launches == before + 1,
                      "greedy_nms counted other than one launch per call")
                want = greedy_keep_reference(boxes, valid, kb.IOU)
                torch.cuda.synchronize()
                n_diff = int((got != want).sum())
                check(n_diff == 0, f"greedy_nms: {n_diff} mask bits differ at "
                      f"B={b} K={k} {case}")
                check(not bool((got & ~valid).any()), "greedy_nms kept an invalid box")
            print(f"kernels: greedy_nms B={b} K={k} masks bit-equal "
                  f"({', '.join(NMS_CHECK_CASES)})", flush=True)
    boxes, valid = kb.make_boxes(rng, 8, 300, "grid")
    ious = torch.unique(box_iou_pairwise(boxes[:1], boxes[:1], eps=1e-9))
    n_thres = 0
    for t in ious[(ious > 0.05) & (ious < 0.95)][::7].tolist():
        for thres in (*np.nextafter(np.float32(t), [np.float32(0), np.float32(1)]).tolist(), t):
            n_diff = int((greedy_keep(boxes, valid, thres)
                          != greedy_keep_reference(boxes, valid, thres)).sum())
            check(n_diff == 0, f"greedy_nms: {n_diff} bits differ at thres {thres!r}")
            n_thres += 1
    print(f"kernels: greedy_nms bit-equal on grid boxes at {n_thres} thresholds "
          "on and beside exact IoU values", flush=True)

    # -- head scores: both paths' level shapes and ragged tiles -----------
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {}
    for batch, grids in HEAD_CHECK_SHAPES:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            raws = kb.head_maps(gen, batch, dtype, grids)
            for classes in (None, torch.arange(80, device="cuda") % 3 != 1):
                before = head_scores.launches
                got = head_scores(raws, kb.CONF, classes)
                check(head_scores.launches == before + 1,
                      "head_scores counted other than one launch per call")
                want = head_scores_reference(raws, kb.CONF, classes)
                torch.cuda.synchronize()
                agree = kb.head_scores_agree(got, want)
                max_err[batch] = max(max_err.get(batch, 0.0), agree["max_abs_err"])
                print(f"kernels: head_scores b{batch} {grids[0][0]}x{grids[0][1]}.. "
                      f"{str(dtype)[6:]} classes={'mask' if classes is not None else 'all'} "
                      f"max_abs_err {agree['max_abs_err']:.3g} ({agree['ulp']} ulp), "
                      f"classes equal, {agree['flips']} gate flips within 1e-6 of conf",
                      flush=True)
            del raws
    # the anchor-major variant: a reference-order head's permuted views
    for batch, grids, n_inputs in ANCHOR_MAJOR_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            for _ in range(n_inputs):
                raws = [r.permute(0, 3, 1, 2, 4) for r in kb.head_maps(gen, batch, dtype, grids)]
                for classes in (None, torch.arange(80, device="cuda") % 3 != 1):
                    before = head_scores.launches
                    got = head_scores(raws, kb.CONF, classes, anchor_major=True)
                    check(head_scores.launches == before + 1,
                          "head_scores counted other than one launch per call")
                    want = head_scores_reference(raws, kb.CONF, classes, anchor_major=True)
                    torch.cuda.synchronize()
                    agree = kb.head_scores_agree(got, want)
                    key = f"anchor_major_{batch}"
                    max_err[key] = max(max_err.get(key, 0.0), agree["max_abs_err"])
                del raws
            print(f"kernels: head_scores anchor-major b{batch} {grids[0][0]}x{grids[0][1]}.. "
                  f"{str(dtype)[6:]}, {n_inputs} input(s), classes all and mask: "
                  f"max_abs_err {max_err[key]:.3g}, classes equal", flush=True)
    try:
        head_scores([torch.zeros(1, 3, 4, 4, 85, device="cuda")], kb.CONF,
                    anchor_major=True)
    except ValueError:
        print("kernels: head_scores refuses anchor-major maps that are not views "
              "of the native memory", flush=True)
    else:
        raise RuntimeError("head_scores accepted anchor-major maps of other memory")
    shifted = torch.zeros(2 * 4 * 4 * 255 + 1, device="cuda",
                          dtype=torch.bfloat16)[1:].view(2, 4, 4, 3, 85)
    try:
        head_scores([shifted], kb.CONF)
    except ValueError:
        print("kernels: head_scores refuses a base off the 16-byte boundary", flush=True)
    else:
        raise RuntimeError("head_scores accepted a misaligned base")
    return max_err


def kernel_times(head_max_err: dict):
    """Each kernel's JSON row at the shape of the path it runs on
    (utils/kernel_bench.py): greedy_nms at the v5s serving step's B=128,
    K=512, as greedy_nms_eval and greedy_nms_train_eval at the eval step's
    B=64, K=2048, as greedy_nms_fit_host at the fit-host validations' B=8,
    K=2048, as greedy_nms_v7 at the v7 serving step's B=64, K=512, as
    greedy_nms_serve at the server's B=8, K=1024 and as
    greedy_nms_mesh_serve at a mesh rank's B=4, K=1024 and as
    greedy_nms_spatial and greedy_nms_video at a spatial request's and a
    video frame's B=1, K=1024; head_scores at b128, as head_scores_v7 at
    b64, as head_scores_anchor_major at b128 on a reference-order head's
    maps, and at b8, b4 and b1 (spatial, video) likewise.
    `head_max_err` holds head_scores' largest error against its plain
    version at each batch (anchor-major under "anchor_major_<batch>"). Runs after the
    latency phases: the profiler that kernel_bench uses for its per-kernel
    split may leave the host's launch path slower for the rest of the
    process."""
    from vision_kit_tpu_torch.utils import kernel_bench as kb

    bench = kb.run()
    rows = {}
    for name, shape in (("greedy_nms", (128, 512)), ("greedy_nms_eval", (64, 2048)),
                        ("greedy_nms_train_eval", (64, 2048)),
                        ("greedy_nms_fit", (64, 2048)),
                        ("greedy_nms_fit_host", (8, 2048)),
                        ("greedy_nms_ddp", (DDP_BATCH // 2, 2048)),
                        ("greedy_nms_mesh_serve", (MESH_FRAMES // 2, 1024)),
                        ("greedy_nms_v7", (64, 512)),
                        ("greedy_nms_serve", (SERVE_BATCH, 1024)),
                        ("greedy_nms_spatial", (1, 1024)),
                        ("greedy_nms_video", (1, 1024))):
        nms = next(r for r in bench["greedy_nms"]
                   if (r["batch"], r["k"], r["case"]) == (*shape, "random"))
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "vision_kit_tpu_torch/csrc/greedy_nms.cu",
            "replaces": "vision_kit_tpu/ops/pallas_nms.py:32",
            "max_abs_err": 0.0, "ms": float(np.mean(nms["current_ms"])),
            "plain_ms": nms["plain_ms"], "bound_ms": nms["bound_ms"],
            "bound_by": nms["bound_by"], "library_ms": None,
        }
    for name, batch, anchor_major in (("head_scores", 128, False),
                                      ("head_scores_v7", 64, False),
                                      ("head_scores_anchor_major", 128, True),
                                      ("head_scores_serve", SERVE_BATCH, False),
                                      ("head_scores_mesh_serve", MESH_FRAMES // 2, False),
                                      ("head_scores_spatial", 1, False),
                                      ("head_scores_video", 1, False)):
        head = next(r for r in bench["head_scores"]
                    if (r["batch"], r["anchor_major"]) == (batch, anchor_major))
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "vision_kit_tpu_torch/csrc/head_scores.cu",
            "replaces": "tools/archive/bench_pallas_score.py:59",
            "max_abs_err": head_max_err[f"anchor_major_{batch}" if anchor_major
                                        else batch],
            "ms": float(np.mean(head["current_ms"])),
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        }
    return rows


@contextlib.contextmanager
def plain_kernels():
    """Run ops/nms.py's postprocesses on the kernels' plain versions."""
    from vision_kit_tpu_torch.ops import greedy_nms, head_scores, nms

    saved = nms.head_scores, nms.greedy_keep
    nms.head_scores = head_scores.head_scores_reference
    nms.greedy_keep = greedy_nms.greedy_keep_reference
    try:
        yield
    finally:
        nms.head_scores, nms.greedy_keep = saved


def reset_counts():
    from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep
    from vision_kit_tpu_torch.ops.head_scores import head_scores

    greedy_keep.launches = 0
    head_scores.launches = 0


def read_counts():
    from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep
    from vision_kit_tpu_torch.ops.head_scores import head_scores

    return {"greedy_nms": greedy_keep.launches,
            "head_scores": head_scores.launches}


def v5s_config():
    from vision_kit_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "yolov5.yaml"))
    cfg.model.version, cfg.model.num_classes = "s", 80
    cfg.model.input_size = [640, 640]
    return cfg


def phase_main_path(rng, smi: str):
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.utils.stream_bench import calibrate_head, same_detections

    cfg = v5s_config()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    calibrate_head(model, 640, seed=1)
    pred = Predictor(model, img_size=640, device="cuda")
    requests = [rng.integers(0, 255, (8, 720, 1280, 3), dtype=np.uint8)
                for _ in range(3)]
    pred.warmup((720, 1280), 8)
    torch.cuda.synchronize()

    reset_counts()
    outs = []
    for frames in requests:
        dets, ms = pred.predict_batch(frames)
        outs.append(dets)
    counts = read_counts()
    print(f"main path: Predictor.predict_batch v5s@640 bf16, 3 requests of "
          f"8x720x1280, launches {counts}, last request {ms:.1f} ms", flush=True)
    for name, n in counts.items():
        check(n > 0, f"main path never launched {name}")

    n_det = 0
    with plain_kernels():
        for frames, got in zip(requests, outs):
            want, _ = pred.predict_batch(frames)
            for w, g in zip(want, got):
                check(g.shape[1:] == (6,) and np.isfinite(g).all(),
                      "non-finite or misshapen detections")
                check(same_detections(w, g, 1e-5, 1e-3),
                      f"detections differ from the plain path ({len(w)} vs {len(g)})")
                n_det += len(g)
    check(n_det > 0, "main path produced no detections")
    print(f"main path: {n_det} detections over 24 frames, equal to the plain "
          "path's (class exact, score 1e-5, box 1e-3 px)", flush=True)

    # an f32 model on the card against the same model on the CPU, small input
    cfg_small = v5s_config()
    cfg_small.model.input_size = [128, 128]
    frames = rng.integers(0, 255, (2, 96, 160, 3), dtype=np.uint8)
    results = []
    for dev in ("cuda", "cpu"):
        m = build_model(cfg_small, device=dev, dtype=torch.float32, seed=0)
        calibrate_head(m, 128, seed=1)
        dets, _ = Predictor(m, img_size=128, device=dev).predict_batch(frames)
        results.append(dets)
    n_small = 0
    for g, w in zip(*results):
        check(same_detections(w, g, 1e-4, 1e-2),
              f"f32 card vs CPU detections differ ({len(w)} vs {len(g)})")
        n_small += len(w)
    check(n_small > 0, "small-input reference produced no detections")
    print(f"main path: f32 v5s@128 on the card equals the CPU run "
          f"({n_small} detections; score 1e-4, box 1e-2 px)", flush=True)

    lat = np.array([pred.predict_batch(requests[i % 3])[1] for i in range(200)])
    print(f"main path: request latency over {len(lat)} requests of 8x720x1280 "
          f"(host clock, upload to detections on the host): median "
          f"{np.median(lat):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, "
          f"min {lat.min():.3f} ms, max {lat.max():.3f} ms on {smi}", flush=True)
    return model, counts


# kernel-name words per group, tried in order (cuDNN's batch-norm kernels
# carry "cudnn" too, so batch norm comes before the convolutions)
PROFILE_GROUPS = (
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw")),
    ("conv", ("conv", "gemm", "xmma", "cudnn", "implicit", "cutlass")),
    ("head_scores", ("head_scores",)),
    ("greedy_nms", ("nms_mask_kernel", "nms_walk_kernel")),
    ("topk_sort", ("topk", "radix", "sort", "select")),
    ("concat", ("catarray",)),
    ("elementwise", ("elementwise", "vectorized", "silu", "unrolled")),
)


@torch.no_grad()
def conv_flops(model, x: torch.Tensor) -> int:
    """Floating-point operations (2 per multiply-add) of every convolution
    in one forward pass of `model` on `x`."""
    total = 0

    def count(mod, _, out):
        nonlocal total
        total += 2 * out.numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    training = model.training
    model.eval()              # a training forward would move the statistics
    model(x, decode=False)
    model.train(training)
    for h in hooks:
        h.remove()
    return total


def profile_device(run, steps: int = 3, groups=PROFILE_GROUPS, ranges=()) -> dict:
    """Device time per run() by kernel group (torch.profiler, kernel events
    only), the device's idle share of the wall time and, for each profiler
    range named in `ranges`, the device time of the kernels launched inside
    it (from the host thread that opened it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    totals = {name: 0.0 for name, _ in groups}
    totals["other"] = 0.0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.key not in ranges]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [[e.key[:70], e.self_device_time_total / 1e3 / steps] for e in kernels[:8]]
    for e in kernels:
        ms = e.self_device_time_total / 1e3 / steps
        key = e.key.lower()
        for name, words in groups:
            if any(w in key for w in words):
                totals[name] += ms
                break
        else:
            totals["other"] += ms
    busy = sum(totals.values())
    if busy == 0:
        return {"device_ms": "not measured"}
    check(busy <= wall_ms * 1.02, f"profile counts {busy:.2f} ms of device time "
          f"in {wall_ms:.2f} ms of wall time: kernels counted twice?")
    spans = {f"{name}_range_ms": sum(e.device_time_total for e in events
                                     if e.key == name and e.device_type == DeviceType.CPU)
             / 1e3 / steps for name in ranges}
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1 - busy / wall_ms,
            **{f"{k}_ms": v for k, v in totals.items()}, **spans, "top_kernels": top}


def profile_steps(model, step, batch: int, size: int = 640,
                  steps: int = 3) -> dict:
    """Device time per step(x) on a uint8 (batch, size, size, 3) input by
    kernel group, the device's idle share of the wall time, and the
    convolutions' bound at the card's bf16 tensor-core peak."""
    dev = next(model.parameters()).device
    x = torch.randint(0, 255, (batch, size, size, 3), dtype=torch.uint8,
                      device=dev)
    flops = conv_flops(model, x)
    prof = profile_device(lambda: step(x), steps)
    if "wall_ms" in prof:
        prof.update(conv_gflop=flops / 1e9,
                    conv_bound_ms=flops / H100_BF16_FLOP_S * 1e3)
    return prof


def recording(step, outs: list):
    """step, with each (dets, valid) it returns appended to outs."""
    def run(imgs):
        dets, valid = step(imgs)
        outs.append((dets, valid))
        return dets, valid
    return run


def host_detections(outs):
    """[(dets, valid)] on the device -> per image (n, 6) arrays."""
    rows = []
    for dets, valid in outs:
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        rows += [d[v] for d, v in zip(dets, valid)]
    return rows


EVAL_METRICS = ("map50", "map50_95", "map75", "mp", "mr")


def topk_routes(model, images: np.ndarray, smi: str) -> None:
    """topk_stable's two routes on the card: the order of ties against a
    stable argsort on the host, then the time of each route beside
    torch.topk at every top-k of the eval and serving postprocesses, on the
    eval step's own scores where it has them."""
    from vision_kit_tpu_torch.ops import nms
    from vision_kit_tpu_torch.utils.kernel_bench import time_ms

    routes = {"sort": nms._topk_by_sort, "int64": nms._topk_by_int64}
    gen = np.random.default_rng(3)
    for shape, k in (((256, 80), 20), ((64, 2048), 300), ((4, 504000), 2048)):
        x = (gen.integers(0, 8, shape) / 8).astype(np.float32)
        x[gen.random(shape) < 0.15] = nms.NEG_INF
        want = np.argsort(-x, axis=-1, kind="stable")[..., :k]
        xt = torch.from_numpy(x).cuda()
        for name, fn in (*routes.items(), ("topk_stable", nms.topk_stable)):
            v, i = fn(xt, k)
            check(np.array_equal(i.cpu().numpy(), want),
                  f"{name} orders ties otherwise than a stable argsort at {shape}")
            check(np.array_equal(v.cpu().numpy(), np.take_along_axis(x, want, -1)),
                  f"{name} values differ from a stable argsort's at {shape}")
    print("eval: topk_stable's sort and int64 routes on the card order ties "
          "as a stable argsort (values on a 1/8 grid; widths 80, 2048, 504000)",
          flush=True)

    with torch.inference_mode():
        decoded, _ = model(torch.as_tensor(images, device="cuda"))
        cls_conf = decoded[..., 5:] * decoded[..., 4:5]
        flat = nms.topk_stable(cls_conf, 20)[0].reshape(64, -1)
        flat = torch.where(flat > 0.001, flat, nms.NEG_INF)
        cand = nms.topk_stable(flat, 2048)[0]
    serving = {}
    g = torch.Generator("cuda").manual_seed(4)
    for b, k in ((128, 512), (8, 1024)):   # scores in order, 40 % kept
        s = torch.rand(b, k, generator=g, device="cuda").sort(dim=1, descending=True)[0]
        kept = torch.rand(b, k, generator=g, device="cuda") < 0.4
        serving[b] = torch.where(kept, s, nms.NEG_INF)
    topk_ms = {}
    for name, x, k in (("top20_of_80 b64", cls_conf, 20),
                       ("top2048_of_504000 b64", flat, 2048),
                       ("max_det300_of_2048 b64", cand, 300),
                       ("max_det300_of_512 b128", serving[128], 300),
                       ("max_det300_of_1024 b8", serving[8], 300)):
        want = torch.topk(x, k, dim=-1)[0]
        topk_ms[name] = {"torch.topk": time_ms(lambda: torch.topk(x, k, dim=-1))}
        for route, fn in routes.items():
            check(torch.equal(fn(x, k)[0], want),
                  f"topk_stable ({route}) values differ from torch.topk's ({name})")
            topk_ms[name][route] = time_ms(lambda: fn(x, k))
    print("eval: top-k ms a call, torch.topk beside topk_stable's sort and "
          "int64 routes: " + json.dumps(topk_ms) + f" on {smi}", flush=True)


def phase_eval(model, rng, smi: str) -> dict:
    """The eval path on the phase-4 model; returns the greedy_nms and
    head_scores launches of its validate run on the kernels."""
    from vision_kit_tpu_torch.classes import COCO
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.train import trainer
    from vision_kit_tpu_torch.train.evaluator import DetEvaluator
    from vision_kit_tpu_torch.train.step import make_eval_step
    from vision_kit_tpu_torch.utils.stream_bench import (
        calibrate_head,
        pseudo_targets,
        run_eval_bench,
        same_detections,
    )

    t_phase = time.perf_counter()
    eval_step = make_eval_step(model)
    frames = [rng.integers(0, 255, (64, 640, 640, 3), dtype=np.uint8)
              for _ in range(4)]
    batches = []
    for bi, images in enumerate(frames):
        dets, valid = eval_step(images)
        batches.append({
            "image": images,
            "targets": pseudo_targets(dets.cpu().numpy(), valid.cpu().numpy(),
                                      (640, 640), rng),
            "info": [(640, 640, 1.0, (0.0, 0.0), 64 * bi + i) for i in range(64)],
            "count": 64})
    torch.cuda.synchronize()

    evaluator = DetEvaluator(COCO, img_size=640)
    reset_counts()
    outs = []
    t0 = time.perf_counter()
    got = trainer.validate(recording(eval_step, outs), batches, evaluator)
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts == {"greedy_nms": 4, "head_scores": 0},
          f"eval path launched {counts}, not one greedy_nms a batch and no head_scores")
    with plain_kernels():
        plain_outs = []
        want = trainer.validate(recording(eval_step, plain_outs), batches, evaluator)
    n_det = 0
    for w, g in zip(host_detections(plain_outs), host_detections(outs)):
        check(g.shape[1:] == (6,) and np.isfinite(g).all(),
              "non-finite or misshapen eval detections")
        check(same_detections(w, g, 1e-5, 1e-3),
              f"eval detections differ from the plain path ({len(w)} vs {len(g)})")
        n_det += len(g)
    for k in EVAL_METRICS:
        check(abs(got[k] - want[k]) <= 1e-9,
              f"eval {k} {got[k]!r} differs from the plain path's {want[k]!r}")
    check(0 < got["map50_95"] < 1, f"eval map50_95 {got['map50_95']} not in (0, 1)")
    print(f"eval: validate v5s@640 bf16 eval protocol, 4 batches of 64, launches "
          f"{counts}; {n_det} detections equal to the plain keep's (class exact, "
          f"score 1e-5, box 1e-3 px); metrics "
          + json.dumps({k: got[k] for k in EVAL_METRICS})
          + f" equal to 1e-9; validate wall {4 * 64 / wall_s:.1f} img/s "
          f"({wall_s * 1e3 / 4:.1f} ms a batch, upload and evaluator included) "
          f"on {smi}", flush=True)

    # f32 v5s@128 on the card against the CPU
    cfg_small = v5s_config()
    cfg_small.model.input_size = [128, 128]
    images = rng.integers(0, 255, (4, 128, 128, 3), dtype=np.uint8)
    steps = {}
    for dev in ("cpu", "cuda"):
        m = build_model(cfg_small, device=dev, dtype=torch.float32, seed=0)
        calibrate_head(m, 128, seed=1)
        steps[dev] = make_eval_step(m)
    dets, valid = steps["cpu"](images)
    batch = {"image": images, "count": 4,
             "info": [(128, 128, 1.0, (0.0, 0.0), i) for i in range(4)],
             "targets": pseudo_targets(dets.numpy(), valid.numpy(), (128, 128), rng)}
    runs = {}
    for dev, step in steps.items():
        step_outs = []
        summary = trainer.validate(recording(step, step_outs), [batch],
                                   DetEvaluator(COCO, img_size=128))
        runs[dev] = (host_detections(step_outs), summary)
    n_small = 0
    for w, g in zip(runs["cpu"][0], runs["cuda"][0]):
        check(same_detections(w, g, 1e-4, 1e-2),
              f"f32 eval card vs CPU detections differ ({len(w)} vs {len(g)})")
        n_small += len(w)
    for k in EVAL_METRICS:
        check(abs(runs["cuda"][1][k] - runs["cpu"][1][k]) <= 1e-6,
              f"f32 eval {k} card {runs['cuda'][1][k]!r} vs CPU {runs['cpu'][1][k]!r}")
    print(f"eval: f32 v5s@128 eval on the card equals the CPU run ({n_small} "
          f"detections; score 1e-4, box 1e-2 px; metrics to 1e-6)", flush=True)

    result = trainer.test(eval_step, batches[:1], evaluator)
    coco = result["coco"]
    check(all(np.isfinite(v) for v in coco.values()) and 0 < coco["map"] < 1,
          f"COCO metric set out of range: {coco}")
    print("eval: trainer.test on one batch, COCO-protocol metrics "
          + json.dumps(coco), flush=True)

    rec = run_eval_bench(model, batch=64, size=640, iters=10, warmup=3)
    print(f"eval: run_eval_bench v5s@640 b64 bf16, calibrated head: "
          f"{rec['value']:.1f} img/s ({rec['step_ms']:.3f} ms a batch, "
          f"{rec['detections']} detections in 10 batches) on {smi}; evaluator "
          f"update (host) {rec['evaluator_update_ms']:.2f} ms a batch, "
          f"{rec['evaluator_update_coco_ms']:.2f} ms with the COCO set", flush=True)

    topk_routes(model, frames[0], smi)
    print(f"eval: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def v7_config(deploy: bool, size: int = 640):
    from vision_kit_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "yolov7.yaml"))
    cfg.model.version, cfg.model.num_classes = "base", 80
    cfg.model.input_size = [size, size]
    cfg.model.deploy = deploy
    return cfg


def folded_v7(size: int, device: str):
    """v7 base in f32: the training structure with its BatchNorm statistics
    and head calibrated at `size`, and the deploy model loaded (strict)
    from its folded state_dict."""
    from vision_kit_tpu_torch.convert import deploy_state_dict
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.utils.stream_bench import calibrate_bn, calibrate_head

    train = build_model(v7_config(False, size), device=device, seed=0)
    calibrate_bn(train, size, seed=2)
    calibrate_head(train, size, seed=1)
    deploy = build_model(v7_config(True, size), device=device, seed=0)
    deploy.load_state_dict(deploy_state_dict(train.state_dict()), strict=True)
    return train, deploy


def phase_v7(rng, smi: str):
    """The v7 paths; returns the bf16 deploy model and the launches of its
    throughput run."""
    from vision_kit_tpu_torch.ops.head_scores import _check
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.utils.stream_bench import (
        run_detector_bench,
        run_eval_bench,
        same_detections,
    )

    t_phase = time.perf_counter()
    train, deploy = folded_v7(640, "cuda")
    x = torch.from_numpy(rng.integers(0, 255, (2, 640, 640, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        want, want_raws = train(x)
        got, got_raws = deploy(x)
    for raws in (want_raws, got_raws):
        _check(raws, None)      # contiguous NHWC views, 16-byte aligned
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=2e-3, atol=2e-3),
          f"v7 deploy output differs from the training structure's (max {err})")
    print(f"v7: base@640 f32, training structure with calibrated head, folded "
          f"by deploy_state_dict: decoded outputs of 2 frames equal to 2e-3 "
          f"(max abs diff {err:.3g}, values up to {float(want.abs().max()):.1f}); "
          "both structures' raw maps pass head_scores' layout check", flush=True)
    del train, want, got, want_raws, got_raws

    deploy = deploy.to(torch.bfloat16)
    with torch.inference_mode():
        _check(deploy(x, decode=False), None)
    pred = Predictor(deploy, img_size=640, device="cuda")
    requests = [rng.integers(0, 255, (8, 720, 1280, 3), dtype=np.uint8)
                for _ in range(3)]
    pred.warmup((720, 1280), 8)
    torch.cuda.synchronize()
    reset_counts()
    outs = []
    for frames in requests:
        dets, ms = pred.predict_batch(frames)
        outs.append(dets)
    counts = read_counts()
    check(counts == {"greedy_nms": 3, "head_scores": 3},
          f"v7 predict_batch launched {counts}, not each kernel once a request")
    n_det = 0
    with plain_kernels():
        for frames, got in zip(requests, outs):
            want, _ = pred.predict_batch(frames)
            for w, g in zip(want, got):
                check(g.shape[1:] == (6,) and np.isfinite(g).all(),
                      "non-finite or misshapen v7 detections")
                check(same_detections(w, g, 1e-5, 1e-3),
                      f"v7 detections differ from the plain path ({len(w)} vs {len(g)})")
                n_det += len(g)
    check(n_det > 0, "v7 predict_batch produced no detections")
    print(f"v7: Predictor.predict_batch base@640 bf16 deploy, 3 requests of "
          f"8x720x1280, launches {counts}; {n_det} detections equal to the "
          f"plain path's (class exact, score 1e-5, box 1e-3 px); last request "
          f"{ms:.1f} ms", flush=True)

    multi = Predictor(deploy, img_size=640, device="cuda", multi_label=True)
    multi.warmup((720, 1280), 8)
    reset_counts()
    got, _ = multi.predict_batch(requests[0])
    counts_multi = read_counts()
    check(counts_multi == {"greedy_nms": 1, "head_scores": 0},
          f"v7 multi-label predict_batch launched {counts_multi}")
    with plain_kernels():
        want, _ = multi.predict_batch(requests[0])
    for w, g in zip(want, got):
        check(same_detections(w, g, 1e-5, 1e-3), "v7 multi-label detections "
              f"differ from the plain path ({len(w)} vs {len(g)})")
    print(f"v7: multi-label predict_batch, one request, launches {counts_multi}; "
          f"{sum(len(g) for g in got)} detections equal to the plain path's",
          flush=True)

    # f32 v7 base@128, the same folded weights (calibrated on the CPU) on
    # the card and the CPU: network outputs to 1e-3, then Predictor's
    # detections. Boxes to 1e-2 px + 1e-4 of the box's longer side: the v7
    # size decode (2 sigmoid)^2 * anchor turns the ~5e-5 of f32 rounding in
    # a logit into ~0.02 px on the 459x401 anchor
    _, cpu_model = folded_v7(128, "cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    x = torch.from_numpy(rng.integers(0, 255, (2, 128, 128, 3), dtype=np.uint8))
    with torch.inference_mode():
        want, want_raws = cpu_model(x)
        got, got_raws = card_model(x.cuda())
    errs = [float((g.cpu() - w).abs().max()) for g, w in
            zip([got, *got_raws], [want, *want_raws])]
    for g, w in zip([got, *got_raws], [want, *want_raws]):
        check(torch.allclose(g.cpu(), w, rtol=1e-3, atol=1e-3),
              f"f32 v7 card vs CPU outputs differ (max abs diffs {errs})")
    frames = rng.integers(0, 255, (2, 96, 160, 3), dtype=np.uint8)
    want, _ = Predictor(cpu_model, img_size=128, device="cpu").predict_batch(frames)
    got, _ = Predictor(card_model, img_size=128, device="cuda").predict_batch(frames)
    n_small = 0
    for w, g in zip(want, got):
        check(same_detections(w, g, 1e-4, 1e-2, 1e-4),
              f"f32 v7 card vs CPU detections differ ({len(w)} vs {len(g)})")
        n_small += len(w)
    check(n_small > 0, "small-input v7 reference produced no detections")
    print(f"v7: f32 base@128 (folded), same weights on the card and the CPU: "
          f"decoded output and raw maps equal to 1e-3 (max abs diffs "
          f"{', '.join(f'{e:.3g}' for e in errs)}), Predictor detections equal "
          f"({n_small}; score 1e-4, box 1e-2 px + 1e-4 of its longer side)",
          flush=True)
    del cpu_model, card_model

    lat = np.array([pred.predict_batch(requests[i % 3])[1] for i in range(100)])
    print(f"v7: request latency over {len(lat)} requests of 8x720x1280 (host "
          f"clock, upload to detections on the host): median "
          f"{np.median(lat):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, "
          f"min {lat.min():.3f} ms, max {lat.max():.3f} ms on {smi}", flush=True)

    reset_counts()
    rec = run_detector_bench(deploy, batch=64, size=640, iters=10, warmup=3)
    bench_counts = read_counts()
    for name, n in bench_counts.items():
        check(n > 0, f"v7 throughput path never launched {name}")
    print(f"v7: run_detector_bench base@640 b64 bf16 deploy, calibrated head: "
          f"{rec['value']:.1f} img/s ({rec['step_ms']:.3f} ms/step, "
          f"{rec['detections']} detections in 10 steps) on {smi}; launches "
          f"{bench_counts}", flush=True)

    reset_counts()
    rec = run_eval_bench(deploy, batch=64, size=640, iters=10, warmup=3)
    eval_counts = read_counts()
    check(eval_counts["greedy_nms"] > 0 and eval_counts["head_scores"] == 0,
          f"v7 eval path launched {eval_counts}")
    print(f"v7: run_eval_bench base@640 b64 bf16 deploy, calibrated head: "
          f"{rec['value']:.1f} img/s ({rec['step_ms']:.3f} ms a batch, "
          f"{rec['detections']} detections in 10 batches) on {smi}; evaluator "
          f"update (host) {rec['evaluator_update_ms']:.2f} ms a batch, "
          f"{rec['evaluator_update_coco_ms']:.2f} ms with the COCO set; "
          f"launches {eval_counts}", flush=True)
    print(f"v7: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return deploy, bench_counts


# the training step's kernel groups, tried in order: foreach updates are the
# optimizer and EMA; the convolutions' backward kernels are named for their
# gradient (dgrad, wgrad), the rest of "conv" is their forward;
# index/scatter/sort kernels are the losses' gathers, scatter-max,
# index_add backward and SimOTA's stable top-k
TRAIN_PROFILE_GROUPS = (
    ("optimizer_ema", ("multi_tensor",)),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("conv_wgrad", ("wgrad",)),
    ("conv_dgrad", ("dgrad",)),
    ("conv", ("conv", "gemm", "xmma", "cudnn", "implicit", "cutlass", "fprop")),
    ("loss_index", ("index", "scatter", "gather", "sort", "radix", "topk")),
    ("concat", ("catarray",)),
    ("pool_upsample", ("pool", "upsample")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "silu", "unrolled")),
)
# the training step's profiler ranges (train/step.py, train/ota.py)
TRAIN_RANGES = ("warp_augment", "loss", "ota_assign", "optimizer", "ema")
TRAIN_BATCH, V7_TRAIN_BATCH = 64, 16   # v7: the paper's 128 over 8 GPUs


def calibrated_v5s():
    """v5s@640 in f32 (the master weights) with its BatchNorm statistics
    and head calibrated on probe batches: the head's unit logit spread then
    holds in training mode too (with the seeded init's identity statistics
    the eval-mode features are tiny, a head scaled to them gives logits of
    ~1e5 once batch statistics normalise, and losses of ~1e10), and the EMA
    model's eval finds crowded detections."""
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.utils.stream_bench import calibrate_bn, calibrate_head

    model = build_model(v5s_config(), device="cuda", seed=0)
    calibrate_bn(model, 640, seed=2)
    calibrate_head(model, 640, seed=1)
    return model


def descend(step, state, data, n: int, what: str):
    """n steps on one batch: every metric finite, the loss of the last below
    the first's. Returns (state, losses, ms a step on the host clock)."""
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = step(state, data)
        metrics.append(m)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    check(all(np.isfinite(list(m.values())).all() for m in metrics),
          f"{what}: a non-finite metric in {metrics}")
    losses = [m["loss"] for m in metrics]
    check(losses[-1] < losses[0], f"{what}: the loss did not fall: {losses}")
    return state, losses, ms


def train_card_vs_cpu() -> str:
    """One f32 step of v5n@128, B=2, on the card and on the CPU from the
    same state, and YoloLossOTA on the same v7 base@128 training maps on
    both (stream_bench's train_step_card_vs_cpu and ota_card_vs_cpu, with
    their tolerances). Returns a summary."""
    from vision_kit_tpu_torch.utils import stream_bench as sb

    cfg = v5s_config()
    cfg.model.version, cfg.model.input_size = "n", [128, 128]
    bad, rel = sb.train_step_card_vs_cpu(cfg)
    check(not bad, f"f32 train step card vs CPU: {bad[:5]}")
    bad, ota = sb.ota_card_vs_cpu(v7_config(False, 128))
    check(not bad, f"OTA loss on the card vs CPU: {bad}")
    return (f"v5n@128 step: metrics within {max(rel.values()):.2g} relative, every state "
            f"tensor within 1e-4 of its magnitude + 2e-3 of the step's change; v7 "
            f"base@128 OTA on the same maps: assignment equal ({ota['fg']} fg), "
            f"loss {ota['loss_rel']:.2g} relative, gradients {ota['grad_rel']:.2g} of "
            "their max")


def phase_train(rng, smi: str) -> dict:
    """The training step on the card; returns the greedy_nms and head_scores
    launches of the EMA model's eval step."""
    from vision_kit_tpu_torch.data.device_aug import warp_augment
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.train.losses import YoloLoss
    from vision_kit_tpu_torch.train.ota import YoloLossOTA
    from vision_kit_tpu_torch.train.step import make_eval_step
    from vision_kit_tpu_torch.utils import stream_bench as sb
    from vision_kit_tpu_torch.utils.kernel_bench import time_ms
    from vision_kit_tpu_torch.utils.stream_bench import same_detections

    t_phase = time.perf_counter()
    model = calibrated_v5s()
    step, state, data = sb.train_bench_setup(
        model, YoloLoss(80, model.head.grid_anchors, sb.TRAIN_HYP), TRAIN_BATCH)
    state, losses, ms = descend(step, state, data, 20, "v5s train")
    print(f"train: v5s@640 b{TRAIN_BATCH} bf16 autocast (f32 parameters), YoloLoss, "
          f"20 steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{ms:.1f} ms a step on the host clock (first steps included)", flush=True)

    # the EMA model through the eval protocol and the greedy-NMS kernel
    eval_step = make_eval_step(model, state=state, compute_dtype=torch.bfloat16)
    images = rng.integers(0, 255, (64, 640, 640, 3), dtype=np.uint8)
    eval_step(images)
    torch.cuda.synchronize()
    reset_counts()
    outs = [eval_step(images)]
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == {"greedy_nms": 1, "head_scores": 0},
          f"EMA eval launched {counts}, not one greedy_nms a batch and no head_scores")
    with plain_kernels():
        want = [eval_step(images)]
    n_det = 0
    for w, g in zip(host_detections(want), host_detections(outs)):
        check(g.shape[1:] == (6,) and np.isfinite(g).all(), "non-finite EMA detections")
        check(same_detections(w, g, 1e-5, 1e-3),
              f"EMA eval detections differ from the plain keep's ({len(w)} vs {len(g)})")
        n_det += len(g)
    check(n_det > 0, "the EMA eval produced no detections")
    print(f"train: EMA model (after {state.ema.updates} updates) through make_eval_step, "
          f"one batch of 64 at 640 in bf16 (autocast over the f32 EMA), eval protocol: "
          f"launches {counts}; {n_det} "
          "detections equal to the plain keep's (class exact, score 1e-5, box 1e-3 px)",
          flush=True)
    del eval_step, outs, want

    recs = {}
    for name, kw in (("plain", {}), ("daug", {"device_aug": True}),
                     ("accum2", {"accum_steps": 2}), ("remat", {"remat": True})):
        torch.cuda.empty_cache()
        recs[name] = sb.run_train_bench(model, YoloLoss(80, model.head.grid_anchors,
                                                        sb.TRAIN_HYP),
                                        batch=TRAIN_BATCH, iters=10, warmup=3, **kw)
    aug = sb.daug_batch(rng, TRAIN_BATCH, 640)
    aug = {k: torch.from_numpy(v).cuda() for k, v in aug.items()}
    aug_ms = time_ms(lambda: warp_augment(aug["tiles"], aug["tile_hw"], aug["params"],
                                          dtype=torch.bfloat16), reps=10)
    check(recs["remat"]["peak_mem_gib"] < recs["plain"]["peak_mem_gib"],
          f"remat did not lower the peak memory: {recs}")
    for name, r in recs.items():
        check(np.isfinite(r["loss"]), f"train bench {name}: loss {r['loss']}")
    print(f"train: run_train_bench v5s@640 b{TRAIN_BATCH} bf16 (3 warmup, 10 timed): "
          + "; ".join(f"{n} {r['value']:.1f} img/s, {r['step_ms']:.3f} ms a step, peak "
                      f"{r['peak_mem_gib']:.2f} GiB" for n, r in recs.items())
          + f"; warp_augment alone {aug_ms:.3f} ms a b{TRAIN_BATCH} batch "
          f"(5 tiles, mixup, fractional affine, HSV, bf16) on {smi}", flush=True)
    del model, step, state, data, aug
    torch.cuda.empty_cache()

    v7 = build_model(v7_config(False), device="cuda", seed=0)
    step, state, data = sb.train_bench_setup(
        v7, YoloLossOTA(80, v7.head.grid_anchors, sb.TRAIN_HYP), V7_TRAIN_BATCH)
    state, losses, ms = descend(step, state, data, 10, "v7 OTA train")
    print(f"train: v7 base@640 training structure b{V7_TRAIN_BATCH} bf16, YoloLossOTA, "
          f"10 steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    del step, state, data
    rec = sb.run_train_bench(v7, YoloLossOTA(80, v7.head.grid_anchors, sb.TRAIN_HYP),
                             batch=V7_TRAIN_BATCH, iters=10, warmup=3)
    print(f"train: run_train_bench v7 base@640 b{V7_TRAIN_BATCH} bf16 OTA: "
          f"{rec['value']:.1f} img/s, {rec['step_ms']:.3f} ms a step, peak "
          f"{rec['peak_mem_gib']:.2f} GiB on {smi}", flush=True)
    del v7
    torch.cuda.empty_cache()

    print("train: f32 card vs CPU: " + train_card_vs_cpu(), flush=True)
    print(f"train: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def serve_requests(pred, requests):
    """Predictor.predict_batch on each request, with the kernels' launch
    counts set to 0 before and read after. Returns (per-image detections,
    counts)."""
    reset_counts()
    dets = []
    for frames in requests:
        dets += pred.predict_batch(frames)[0]
    return dets, read_counts()


def check_same(want, got, what: str, box_rtol: float = 0.0) -> int:
    """Per-image detection sets equal (class exact, score 1e-5, box 1e-3 px
    + box_rtol of the box's longer side); returns the detections."""
    from vision_kit_tpu_torch.utils.stream_bench import same_detections

    for w, g in zip(want, got, strict=True):
        check(g.shape[1:] == (6,) and np.isfinite(g).all(),
              f"{what}: non-finite or misshapen detections")
        check(same_detections(w, g, 1e-5, 1e-3, box_rtol),
              f"{what}: detections differ ({len(w)} vs {len(g)})")
    n = sum(len(g) for g in got)
    check(n > 0, f"{what}: no detections")
    return n


def upstream_ordered(sd: dict, model) -> dict:
    """`sd` as an upstream checkpoint holds it: `model.<i>.<leaf>` names in
    the reference's declaration order (convert.vision_kit_key_order), with
    the head's anchors and anchor_grid buffers ahead of its convs."""
    from vision_kit_tpu_torch.convert import vision_kit_key_order

    out = {}
    for i, key in enumerate(vision_kit_key_order(model)):
        if key == "head.m.0.weight":
            out["model.24.anchors"] = torch.ones(3, 3, 2)
            out["model.24.anchor_grid"] = torch.ones(3, 1, 3, 1, 1, 2)
        out[f"model.{i}.{key.rsplit('.', 1)[1]}"] = sd[key]
    return out


def phase_weights(model, rng, smi: str) -> dict:
    """Checkpoints, reference-order serving and export on the card, from the
    phase-4 model (v5s@640 bf16, calibrated head). Returns the launches of
    the reference-order serving run."""
    import tempfile

    from vision_kit_tpu_torch.convert import (
        deploy_state_dict,
        load_upstream_checkpoint,
        upstream_to_vision_kit,
    )
    from vision_kit_tpu_torch.export import run_export
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.predictor import (
        Predictor,
        load_predictor_from_config,
        load_weights,
        merge_matching,
    )
    from vision_kit_tpu_torch.train.checkpoint import save_checkpoint
    from vision_kit_tpu_torch.train.losses import YoloLoss
    from vision_kit_tpu_torch.utils import stream_bench as sb

    t_phase = time.perf_counter()
    cfg = v5s_config()
    requests = [rng.integers(0, 255, (8, 720, 1280, 3), dtype=np.uint8)
                for _ in range(3)]
    pred = Predictor(model, img_size=640, device="cuda")
    pred.warmup((720, 1280), 8)
    want, _ = serve_requests(pred, requests)
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    tmp = tempfile.TemporaryDirectory()
    files = {"plain": os.path.join(tmp.name, "plain.pt"),
             "lightning": os.path.join(tmp.name, "lightning.pt"),
             "upstream": os.path.join(tmp.name, "upstream.pt"),
             "train_state": os.path.join(tmp.name, "last.pt")}
    torch.save(sd, files["plain"])
    # the training weights (head kernels halved) beside the EMA, which wins
    lightning = {f"model.{k}": v * 0.5 if k.startswith("head.m.") else v
                 for k, v in sd.items()}
    lightning.update({f"ema_model.{k}": v for k, v in sd.items()})
    torch.save({"state_dict": lightning, "epoch": 3}, files["lightning"])
    torch.save({"model": upstream_ordered(sd, model)}, files["upstream"])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_weights(files["plain"], model)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    print(f"weights: load_weights of a v5s .pt ({os.path.getsize(files['plain']) / 1e6:.1f} "
          f"MB, {len(sd)} entries) into the bf16 model on the card: {load_ms:.1f} ms "
          f"(host clock) on {smi}", flush=True)

    for form in ("plain", "lightning", "upstream"):
        if form == "upstream":    # the zip-map, then a vision_kit .pt
            mapped = upstream_to_vision_kit(load_upstream_checkpoint(files[form]), model)
            torch.save({"model": mapped}, files[form])
        loaded = load_predictor_from_config(cfg, weights=files[form], device="cuda",
                                            dtype=torch.bfloat16, seed=3)
        got, counts = serve_requests(loaded, requests)
        n = check_same(want, got, f"{form} checkpoint")
        check(counts == {"greedy_nms": 3, "head_scores": 3},
              f"{form} checkpoint served with launches {counts}")
        print(f"weights: {form} .pt through load_predictor_from_config, 3 requests of "
              f"8x720x1280: {n} detections equal to the in-memory model's (class "
              f"exact, score 1e-5, box 1e-3 px), launches {counts}", flush=True)
        del loaded

    # a TrainState after two training steps: the loader serves its EMA
    train = calibrated_v5s()
    step, state, data = sb.train_bench_setup(
        train, YoloLoss(80, train.head.grid_anchors, sb.TRAIN_HYP), 16)
    for _ in range(2):
        state, _ = step(state, data)
    save_checkpoint(files["train_state"], state, epoch=0)
    ema = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    ema.load_state_dict(merge_matching(ema.state_dict(), state.ema.tree), strict=True)
    want_ema, _ = serve_requests(Predictor(ema, img_size=640, device="cuda"), requests)
    loaded = load_predictor_from_config(cfg, weights=files["train_state"], device="cuda",
                                        dtype=torch.bfloat16, seed=3)
    got, counts = serve_requests(loaded, requests)
    n = check_same(want_ema, got, "TrainState checkpoint")
    check(counts == {"greedy_nms": 3, "head_scores": 3},
          f"TrainState checkpoint served with launches {counts}")
    print(f"weights: TrainState after 2 v5s training steps (EMA {state.ema.updates} "
          f"updates) through load_predictor_from_config: {n} detections equal to the "
          f"in-memory EMA model's, launches {counts}", flush=True)
    del train, step, state, data, ema, loaded
    torch.cuda.empty_cache()

    # v7 base training weights into a deploy model, folded at load time; the
    # in-memory fold is made on the host too, where load_weights folds a
    # file's weights (a fold on the card rounds its matvec otherwise, and
    # the seeded v7's NMS near-ties turn on such ulps)
    v7_train, _ = folded_v7(640, "cuda")
    train_sd = {k: v.cpu() for k, v in v7_train.state_dict().items()}
    torch.save({"model": train_sd}, files["plain"])
    v7_deploy = build_model(v7_config(True), device="cuda", seed=0)
    v7_deploy.load_state_dict(deploy_state_dict(train_sd), strict=True)
    v7_loaded = load_weights(files["plain"], build_model(v7_config(True), device="cuda"))
    want_v7, _ = serve_requests(Predictor(v7_deploy, img_size=640, device="cuda"), requests)
    got, counts = serve_requests(Predictor(v7_loaded, img_size=640, device="cuda"), requests)
    n = check_same(want_v7, got, "v7 training weights into deploy", box_rtol=1e-4)
    check(counts == {"greedy_nms": 3, "head_scores": 3},
          f"v7 deploy from training weights served with launches {counts}")
    print(f"weights: v7 base training-structure .pt loaded into a deploy model (folded "
          f"on load), f32: {n} detections equal to the in-memory fold's (class exact, "
          f"score 1e-5, box 1e-3 px + 1e-4 of its longer side), launches {counts}",
          flush=True)
    del v7_train, v7_deploy, v7_loaded
    torch.cuda.empty_cache()

    # the same v5s weights in a decode_order="reference" model
    ref = build_model(cfg, device="cuda", dtype=torch.bfloat16, decode_order="reference")
    ref.load_state_dict(model.state_dict(), strict=True)
    ref_pred = Predictor(ref, img_size=640, device="cuda")
    ref_pred.warmup((720, 1280), 8)
    got, ref_counts = serve_requests(ref_pred, requests)
    check(ref_counts == {"greedy_nms": 3, "head_scores": 3},
          f"reference-order serving launched {ref_counts}")
    n = check_same(want, got, "reference-order serving")
    with plain_kernels():
        plain, _ = serve_requests(ref_pred, requests)
    check_same(plain, got, "reference-order serving against the plain versions")
    print(f"weights: reference-order v5s through Predictor, 3 requests: launches "
          f"{ref_counts} (anchor-major head_scores); {n} detections equal to the "
          "native order's and to the plain versions' (class exact, score 1e-5, box "
          "1e-3 px)", flush=True)
    lat = {"native": [], "reference": []}
    for name in ("native", "reference", "reference", "native"):
        p = pred if name == "native" else ref_pred
        lat[name] += [p.predict_batch(requests[i % 3])[1] for i in range(50)]
    print("weights: request latency of 8x720x1280, native and reference order in "
          "turns (native, reference, reference, native; 50 requests each, host "
          "clock): " + ", ".join(
              f"{k} median {np.median(v):.3f} ms, p99 {np.percentile(v, 99):.3f} ms"
              for k, v in lat.items()) + f" on {smi}", flush=True)
    del ref, ref_pred

    t0 = time.perf_counter()
    res = run_export(cfg, model, os.path.join(tmp.name, "export"))
    export_s = time.perf_counter() - t0
    for kind in ("msgpack", "weights", "torch_export", "torchscript"):
        check(kind in res.artifacts, f"export: no checked {kind} artifact "
              f"({res.skipped.get(kind)})")
    check(res.checks["msgpack"] == 0.0, f"export: msgpack delta {res.checks['msgpack']}")
    print(f"weights: run_export v5s@640 f32 on the card in {export_s:.1f} s: checks "
          + json.dumps(res.checks) + "; skipped " + json.dumps(res.skipped), flush=True)
    # the msgpack leg (the JAX package's weights format) served on the card
    t0 = time.perf_counter()
    loaded = load_predictor_from_config(cfg, weights=res.artifacts["msgpack"], device="cuda",
                                        dtype=torch.bfloat16, seed=3)
    torch.cuda.synchronize()
    msgpack_load_s = time.perf_counter() - t0
    got, counts = serve_requests(loaded, requests)
    n = check_same(want, got, "the msgpack export served")
    check(all(np.array_equal(w, g) for w, g in zip(want, got)),
          "the msgpack export's detections are not bit-equal to the in-memory model's")
    check(counts == {"greedy_nms": 3, "head_scores": 3},
          f"the msgpack export served with launches {counts}")
    mb = os.path.getsize(res.artifacts["msgpack"]) / 1e6
    print(f"weights: the export's Flax msgpack ({mb:.1f} MB) through load_predictor_from_config on the card in {msgpack_load_s:.2f} s: "
          f"3 requests of 8x720x1280, {n} detections bit-equal to the in-memory model's, "
          f"launches {counts}", flush=True)
    del loaded
    tmp.cleanup()
    print(f"weights: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ref_counts


# the demo's Motion-JPEG clip: the 720x1280 samples in turn (12 frames since
# its output is mp4v, ~0.4 s a frame to encode)
VIDEO_FRAMES, VIDEO_FPS = 12, 30.0


def phase_demo(model, smi: str) -> dict:
    """`python -m vision_kit_tpu_torch demo` on the card in child processes,
    the phase-4 model's weights (calibrated head) handed over as a Flax
    msgpack, f32 as the demo builds it. Images (-p the samples): one JPEG
    written per sample the port decodes, each printed count equal to an
    in-process Predictor's on the same decoded image; one sample's -o .webp
    output (in this process) read back equal to its -o .bmp output. Video
    (-p clip.avi -o
    out.avi, through chip_smoke.py --demo-video so that the child's kernel
    wrappers can be counted): utils/video_bench.py's clip of the 720x1280
    samples, 12 frames at 30 fps; VideoReader's frames (plain decoder bit
    for bit, nvJPEG within its tolerance, threaded = unthreaded), each
    frame's detections equal to an in-process Predictor's on the same
    nvJPEG-decoded frame (class exact, score 1e-5, box 1e-3 px), one launch
    of each kernel a frame, out.avi mp4v as the JAX writer writes it (the
    handler and biCompression mp4v, the VOL headers before the first VOP):
    every chunk Mp4vEncoder's VOP of the drawn frame, read back by the host
    C++ decoder as its reconstruction; the ms a frame by stage. Then
    mp4_leg, mkv_leg, vpx_leg for VP8 and VP9, and tags_leg. Returns the video
    runs' launches, summed, and the Matroska, VP8, VP9 and tags legs'
    seconds."""
    import re
    import subprocess
    import tempfile

    from vision_kit_tpu_torch.classes import COCO
    from vision_kit_tpu_torch.convert import jax_variables_from_state_dict
    from vision_kit_tpu_torch.data import mpeg4
    from vision_kit_tpu_torch.data.decode import decode_image, decode_to
    from vision_kit_tpu_torch.predictor import load_predictor_from_config
    from vision_kit_tpu_torch.utils import flax_msgpack
    from vision_kit_tpu_torch.utils import video_bench as vb
    from vision_kit_tpu_torch.utils.avi import read_avi
    from vision_kit_tpu_torch.utils.drawing import Drawing
    from vision_kit_tpu_torch.utils.readers import ImageReader, VideoReader
    from vision_kit_tpu_torch.utils.stream_bench import same_detections

    t_phase = time.perf_counter()
    samples = os.path.join(REPO, "vision_kit_tpu_torch", "data", "samples")
    # the children run with torch's defaults: cuDNN's f32 convs in TF32
    tf32 = dict(enabled=True, benchmark=False, deterministic=False, allow_tf32=True)
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "v5s.msgpack")
        flax_msgpack.write_file(weights, jax_variables_from_state_dict(model.state_dict()))
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "vision_kit_tpu_torch", "demo", "-p",
                            samples, "-o", out, "-w", weights], cwd=REPO,
                           capture_output=True, text=True, timeout=300)
        demo_s = time.perf_counter() - t0
        check(r.returncode == 0, f"the demo exited {r.returncode}: {r.stderr[-3000:]}")
        printed = dict(re.findall(r"^(.+): (\d+) detections in [0-9.]+ ms$", r.stdout,
                                  re.MULTILINE))
        files = ImageReader(samples).files
        readable = []
        for path in files:
            with open(path, "rb") as f:
                if decode_image(f.read()) is not None:
                    readable.append(path)
        written = sorted(os.listdir(out))
        check(written == sorted(os.path.splitext(os.path.basename(p))[0] + "_res.jpg"
                                for p in readable),
              f"the demo wrote {written} for {len(readable)} readable samples")
        check(sorted(printed) == sorted(readable), f"the demo printed {sorted(printed)}")
        names = [os.path.basename(p) for p in readable]
        check({"progressive_240x320.jpg", "rgb24_120x160.bmp", "lossy_240x320.webp",
               "exif6_120x160.webp"} <= set(names),
              f"the demo did not read the progressive JPEG, the BMP and the WebPs: {names}")
        pred = load_predictor_from_config(v5s_config(), weights=weights, device="cuda")
        want = {}
        with torch.backends.cudnn.flags(**tf32):
            for path in readable:
                with open(path, "rb") as f:
                    want[path] = len(pred(decode_image(f.read()))[0])
        check({p: int(n) for p, n in printed.items()} == want,
              f"the demo's counts {printed} differ from in-process ones {want}")
        check(sum(want.values()) > 0, "the demo found no detections")
        for name in written[:2]:
            with open(os.path.join(out, name), "rb") as f:
                check(decode_image(f.read()) is not None, f"the demo's {name} does not decode")
        print(f"demo: python -m vision_kit_tpu_torch demo -p vision_kit_tpu_torch/data/samples "
              f"-w <the phase-4 weights as a Flax msgpack>: exit 0 in {demo_s:.1f} s, "
              f"{len(written)} JPEGs for the {len(readable)} of {len(files)} samples the "
              f"port decodes (progressive, CMYK/YCCK/RGB JPEGs, BMPs and WebPs among them); "
              f"detections by image {sorted(want.values())}, equal to an in-process "
              f"Predictor's on {smi}", flush=True)

        # a .webp output (lossless VP8L), in this process: read back equal to
        # the .bmp output of the same drawn frame, and to encode_webp's bytes
        from vision_kit_tpu_torch import __main__ as cli
        from vision_kit_tpu_torch.data import webp as webp_dec
        from vision_kit_tpu_torch.data.encode import encode_webp

        t0 = time.perf_counter()
        one = os.path.join(samples, "odd_333x517.jpg")
        outs = {ext: os.path.join(tmp, f"one.{ext}") for ext in ("bmp", "webp")}
        with contextlib.redirect_stdout(io.StringIO()):
            for path in outs.values():
                check(cli.main(["demo", "-p", one, "-o", path, "-w", weights]) == 0,
                      f"the demo did not write {path}")
        with open(outs["bmp"], "rb") as f:
            drawn = decode_image(f.read())
        with open(outs["webp"], "rb") as f:
            written_webp = f.read()
        back, _ = webp_dec.decode_webp(written_webp)
        t_enc = time.perf_counter()
        again = encode_webp(drawn)
        enc_ms = (time.perf_counter() - t_enc) * 1e3
        check(np.array_equal(back, drawn) and again == written_webp,
              "the demo's .webp output does not read back as its drawn frame")
        print(f"demo: -p odd_333x517.jpg -o one.webp: {len(written_webp)} B of lossless "
              f"VP8L (the .bmp output {os.path.getsize(outs['bmp'])} B), read back by "
              f"data/webp.py bit-equal to the .bmp's drawn frame and to encode_webp's "
              f"bytes; encode_webp {enc_ms:.1f} ms (host clock); the leg "
              f"{time.perf_counter() - t0:.1f} s on {smi}", flush=True)

        # video: the samples as a Motion-JPEG clip, through the CLI in a child
        t_video = time.perf_counter()
        clip, out_avi = os.path.join(tmp, "clip.avi"), os.path.join(tmp, "out.avi")
        jpegs = vb.write_sample_clip(clip, VIDEO_FRAMES, VIDEO_FPS)
        bad = vb.reader_disagreements(clip, jpegs, VIDEO_FPS, "cuda")
        check(bad == [], f"VideoReader: {bad[:5]}")
        reader_s = time.perf_counter() - t_video
        # the six video runs (this clip, the committed mp4v .mp4 and .mkv,
        # the committed VP8 and VP9 .webm and Motion JPEG 2000 .mov without
        # -o) in one child; each leg checks its own
        out_mp4, out_mkv = os.path.join(tmp, "out.mp4"), os.path.join(tmp, "out.mkv")
        (res, res_mp4, res_mkv, res_vp8, res_vp9, res_mj2), child_s = video_runs(weights, [
            (clip, out_avi), (os.path.join(vb.VIDEO_SAMPLES, vb.HD_CLIP), out_mp4),
            (os.path.join(vb.VIDEO_SAMPLES, vb.HD_MKV), out_mkv),
            (os.path.join(vb.VIDEO_SAMPLES, vb.VP8_HD), "-"),
            (os.path.join(vb.VIDEO_SAMPLES, vb.VP9_HD), "-"),
            (os.path.join(vb.TAG_SAMPLES, vb.MJ2_MOV), "-")])
        print(f"demo: the six video runs in one --demo-video child: {child_s:.1f} s "
              f"(runs {res['run_s']:.1f}, {res_mp4['run_s']:.1f}, {res_mkv['run_s']:.1f}, "
              f"{res_vp8['run_s']:.1f}, {res_vp9['run_s']:.1f}, {res_mj2['run_s']:.1f} s)",
              flush=True)
        check(f"over {VIDEO_FRAMES} frames" in res["printed"], "the demo printed no average")
        counts = res["counts"]
        check(counts == {"greedy_nms": VIDEO_FRAMES, "head_scores": VIDEO_FRAMES},
              f"the video demo launched {counts}, not one of each a frame")
        check(len(res["detections"]) == VIDEO_FRAMES and res["fps"] == VIDEO_FPS,
              f"the demo read {len(res['detections'])} frames at {res['fps']} fps")
        movie = read_avi(out_avi)
        check((len(movie.frames), movie.fps, movie.width, movie.height, movie.codec, movie.tag)
              == (VIDEO_FRAMES, VIDEO_FPS, 1280, 720, "mpeg4", b"mp4v"),
              f"out.avi: {len(movie.frames)} frames of {movie.codec} ({movie.tag}) at "
              f"{movie.fps} fps")
        with open(out_avi, "rb") as f:
            head = f.read(4096)
        check(head[head.find(b"strh") + 12:][:4] == b"mp4v",
              "out.avi's stream handler is not mp4v")
        check(len(VideoReader(out_avi, decoder="plain")) == VIDEO_FRAMES,
              "the port's reader does not read out.avi whole")
        drawer = Drawing(list(COCO))
        encoder = mpeg4.Mp4vEncoder(1280, 720, VIDEO_FPS)
        back = mpeg4.Mpeg4Decoder(None, "cuda", codec_tag=movie.tag)
        n_det = 0
        with torch.backends.cudnn.flags(**tf32), open(out_avi, "rb") as f:
            frames = {data: decode_to(data, "cuda") for data in set(jpegs)}
            for i, (data, got) in enumerate(zip(jpegs, res["detections"])):
                got = np.asarray(got, np.float32).reshape(-1, 6)
                w, _ = pred(frames[data])
                check(got.shape[1:] == (6,) and np.isfinite(got).all(),
                      f"frame {i}: non-finite or misshapen detections")
                check(same_detections(w, got, 1e-5, 1e-3),
                      f"frame {i}: {len(got)} detections against in-process {len(w)}")
                vop, _ = encoder.encode(drawer.draw(frames[data].cpu().numpy(), got))
                chunk = movie.read_frame(f, i)
                check(chunk == (encoder.headers() if i == 0 else b"") + vop,
                      f"out.avi frame {i} is not Mp4vEncoder's VOP of the drawn frame")
                planes = back.decode(chunk)
                check(all(np.array_equal(p, q[:p.shape[0], :p.shape[1]])
                          for p, q in zip(planes, encoder.recon)),
                      f"out.avi frame {i} does not read back as the encoder's reconstruction")
                n_det += len(got)
        back.close()
        check(n_det > 0, "the video demo found no detections")
        ms = {k: float(np.median(v)) for k, v in res["ms"].items()}
        print(f"demo: python -m vision_kit_tpu_torch demo -p clip.avi -o out.avi (v5s@640 "
              f"f32, {VIDEO_FRAMES} frames of 720x1280 Motion-JPEG at {VIDEO_FPS:g} fps, "
              f"nvJPEG): {n_det} detections, each frame equal to an in-process Predictor's "
              f"(class exact, score 1e-5, box 1e-3 px), launches {counts}; out.avi mp4v "
              f"(handler and biCompression), every chunk Mp4vEncoder's VOP of the drawn "
              f"frame, read back as its reconstruction; VideoReader "
              f"plain bit-equal to decode_image (each sample once), nvJPEG within "
              f"NVJPEG_TOLERANCE, threaded = unthreaded ({reader_s:.1f} s); median ms a "
              f"frame (host clock): read/decode "
              f"{ms['read']:.3f}, predict {ms['predict']:.3f}, draw {ms['draw']:.3f}, encode "
              f"{ms['encode']:.3f}; {VIDEO_FRAMES / res['wall_s']:.2f} fps over the loop "
              f"({res['wall_s']:.2f} s), the run {res['run_s']:.1f} s; the video leg "
              f"{time.perf_counter() - t_video:.1f} s on {smi}", flush=True)
        counts_mp4 = mp4_leg(res_mp4, out_mp4, pred, tf32, smi)
        t_mkv = time.perf_counter()
        counts_mkv = mkv_leg(res_mkv, out_mkv, pred, tf32, smi, (res_mp4, out_mp4))
        mkv_s = time.perf_counter() - t_mkv + res_mkv["run_s"]
        t_vp8 = time.perf_counter()
        counts_vp8 = vpx_leg("vp8", res_vp8, pred, tf32, smi)
        vp8_s = time.perf_counter() - t_vp8 + res_vp8["run_s"]
        t_vp9 = time.perf_counter()
        counts_vp9 = vpx_leg("vp9", res_vp9, pred, tf32, smi)
        vp9_s = time.perf_counter() - t_vp9 + res_vp9["run_s"]
        t_tags = time.perf_counter()
        counts_mj2 = tags_leg(res_mj2, pred, tf32, smi)
        tags_s = time.perf_counter() - t_tags + res_mj2["run_s"]
    print(f"demo: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ({k: counts[k] + counts_mp4[k] + counts_mkv[k] + counts_vp8[k] + counts_vp9[k]
             + counts_mj2[k] for k in counts},
            {"mkv leg": mkv_s, "vp8 leg": vp8_s, "vp9 leg": vp9_s, "tags leg": tags_s})


def mp4_leg(res: dict, out_mp4: str, pred, tf32: dict, smi: str) -> dict:
    """The demo's video mode on MPEG-4 Part 2: the committed mp4v clips
    (data/video_samples/, written by cv2) through the host C++ decoder,
    every frame's RGB on the card at the sha256 of cv2's frame, the small
    AVI's frames and the 720p clip's first GOP and next I-VOP bit-equal to
    the plain decoder's (video_bench.mpeg4_disagreements), the ms a 720p
    I- and P-VOP by each and Mp4vEncoder's ms a frame; then `res`, the run
    of `demo -p mp4v_720x1280_24f.mp4 -o out_mp4` in the --demo-video child
    (its launches counted): one launch of each kernel a frame, each frame's
    detections equal to an in-process Predictor's on the same decoded
    frame, out.mp4's VOPs the bytes Mp4vEncoder gives for the drawn frames
    and its read-back (the C++ decoder) equal to the encoder's
    reconstruction. Returns the run's launches."""
    from vision_kit_tpu_torch.classes import COCO
    from vision_kit_tpu_torch.data import mpeg4
    from vision_kit_tpu_torch.utils import video_bench as vb
    from vision_kit_tpu_torch.utils.drawing import Drawing
    from vision_kit_tpu_torch.utils.mp4 import read_mp4
    from vision_kit_tpu_torch.utils.readers import VideoReader
    from vision_kit_tpu_torch.utils.stream_bench import same_detections

    t_leg = time.perf_counter()
    bad, dec_ms = vb.mpeg4_disagreements({vb.SMALL_CLIP: 10, vb.HD_CLIP: 9})
    check(bad == [], f"the MPEG-4 decoders: {bad[:5]}")
    checks_s = time.perf_counter() - t_leg
    clip = os.path.join(vb.VIDEO_SAMPLES, vb.HD_CLIP)
    n = vb.video_manifest()[vb.HD_CLIP]["frames"]
    reader = VideoReader(clip, use_thread=False)
    frames = [fr for ok, fr in reader if ok]
    check(reader.decoder == "host_cpp" and len(frames) == n,
          f"VideoReader took {reader.decoder} and read {len(frames)} of {n} frames")
    enc = vb.encode_ms([fr.cpu().numpy() for fr in frames[:4]])
    counts = res["counts"]
    check(counts == {"greedy_nms": n, "head_scores": n},
          f"the mp4 video demo launched {counts}, not one of each a frame")
    check(len(res["detections"]) == n and res["fps"] == VIDEO_FPS,
          f"the mp4 demo read {len(res['detections'])} frames at {res['fps']} fps")
    movie = read_mp4(out_mp4)
    check((len(movie.frames), movie.fps, movie.width, movie.height) == (n, VIDEO_FPS, 1280, 720),
          f"out.mp4: {len(movie.frames)} frames at {movie.fps} fps")
    drawer = Drawing(list(COCO))
    encoder = mpeg4.Mp4vEncoder(1280, 720, VIDEO_FPS)
    back = mpeg4.Mpeg4Decoder(movie.config, "cuda")
    check(movie.config == encoder.headers(), "out.mp4's esds is not the encoder's VOL")
    n_det = 0
    with torch.backends.cudnn.flags(**tf32), open(out_mp4, "rb") as f:
        for i, (frame, got) in enumerate(zip(frames, res["detections"])):
            got = np.asarray(got, np.float32).reshape(-1, 6)
            w, _ = pred(frame)
            check(got.shape[1:] == (6,) and np.isfinite(got).all(),
                  f"mp4 frame {i}: non-finite or misshapen detections")
            check(same_detections(w, got, 1e-5, 1e-3),
                  f"mp4 frame {i}: {len(got)} detections against in-process {len(w)}")
            vop, _ = encoder.encode(drawer.draw(frame.cpu().numpy(), got))
            data = movie.read_frame(f, i)
            check(data == vop, f"out.mp4 frame {i} is not Mp4vEncoder's VOP of the drawn frame")
            planes = back.decode(data)
            check(all(np.array_equal(p, q[:p.shape[0], :p.shape[1]])
                      for p, q in zip(planes, encoder.recon)),
                  f"out.mp4 frame {i} does not read back as the encoder's reconstruction")
            n_det += len(got)
    back.close()
    check(n_det > 0, "the mp4 video demo found no detections")
    ms = {k: float(np.median(v)) for k, v in res["ms"].items()}
    size = os.path.getsize(clip)
    print(f"demo: the MPEG-4 decoders on data/video_samples/ (cv2's mp4v): the host C++ "
          f"decoder's RGB (yuv420_to_rgb on the card) at cv2's sha256 on every frame of "
          f"{vb.HD_CLIP} and {vb.SMALL_CLIP}, the plain decoder's planes bit-equal on "
          f"{vb.SMALL_CLIP} and the 720p clip's first GOP and next I-VOP "
          f"({checks_s:.1f} s); a 720x1280 VOP (host clock, median ms): C++ I "
          f"{dec_ms['cpp']['I']:.2f}, P {dec_ms['cpp']['P']:.2f}; plain I "
          f"{dec_ms['plain']['I']:.1f}, P {dec_ms['plain']['P']:.1f}; Mp4vEncoder a 720x1280 "
          f"frame I {enc['I']:.1f} ms, P {enc['P']:.1f} ms ({enc['bytes']} B for 4 frames) on "
          f"{smi}", flush=True)
    print(f"demo: python -m vision_kit_tpu_torch demo -p {vb.HD_CLIP} -o out.mp4 (v5s@640 f32, "
          f"{n} frames of 720x1280 mp4v, {size} B, at {VIDEO_FPS:g} fps, the host C++ "
          f"decoder): {n_det} detections, each frame equal to an in-process Predictor's "
          f"(class exact, score 1e-5, box 1e-3 px), launches {counts}; out.mp4 "
          f"({os.path.getsize(out_mp4)} B) every VOP Mp4vEncoder's bytes of the drawn frame, "
          f"read back equal to its reconstruction; median ms a frame (host clock): "
          f"read/decode {ms['read']:.3f}, predict {ms['predict']:.3f}, draw {ms['draw']:.3f}, "
          f"encode {ms['encode']:.3f}; {n / res['wall_s']:.2f} fps over the loop "
          f"({res['wall_s']:.2f} s), the run {res['run_s']:.1f} s; the mp4 leg "
          f"{time.perf_counter() - t_leg + res['run_s']:.1f} s on {smi}", flush=True)
    return counts


def mkv_leg(res: dict, out_mkv: str, pred, tf32: dict, smi: str, mp4_run: tuple) -> dict:
    """The demo's video mode on Matroska: the committed cv2-written 720p
    mp4v .mkv through VideoReader (utils/mkv.py's demuxer, the host C++
    decoder), every frame's RGB on the card at the sha256 of cv2's frame;
    the XviD-tagged AVI through the C++ decoder (the XviD IDCT, every frame
    at cv2's sha256, bit-equal to the plain decoder); the V_MJPEG .mkv
    through nvJPEG within NVJPEG_TOLERANCE of the plain decoder (threaded =
    unthreaded); the demux ms a frame and the C++ decoder's ms a 720p VOP
    with the simple and the XviD IDCT; then `res`, the run of `demo -p
    mp4v_720x1280_24f.mkv -o out_mkv` in the --demo-video child: one launch
    of each kernel a frame, each frame's detections equal to an in-process
    Predictor's on
    the same decoded frame, out.mkv's blocks Mp4vEncoder's VOPs of the
    drawn frames, its CodecPrivate the encoder's VOL, read back by the C++
    decoder as the encoder's reconstruction. The .mkv holds the .mp4's
    frames (cv2's sha256 of each): where the run gave the mp4 run's
    detections exactly (mp4_run: that run and out.mp4's path), the blocks
    are held to out.mp4's VOPs, which mp4_leg held to the encoder and its
    reconstruction; else they are encoded and read back here. Returns the
    run's launches."""
    import hashlib

    from vision_kit_tpu_torch.classes import COCO
    from vision_kit_tpu_torch.data import mpeg4
    from vision_kit_tpu_torch.utils import video_bench as vb
    from vision_kit_tpu_torch.utils.drawing import Drawing
    from vision_kit_tpu_torch.utils.mkv import read_mkv
    from vision_kit_tpu_torch.utils.mp4 import read_mp4
    from vision_kit_tpu_torch.utils.readers import VideoReader, open_movie
    from vision_kit_tpu_torch.utils.stream_bench import same_detections

    t_leg = time.perf_counter()
    manifest = vb.video_manifest()
    clip = os.path.join(vb.VIDEO_SAMPLES, vb.HD_MKV)
    meta = manifest[vb.HD_MKV]
    n = meta["frames"]
    reader = VideoReader(clip, use_thread=False)
    frames = [fr for ok, fr in reader if ok]
    check(reader.decoder == "host_cpp" and len(frames) == n and reader.fps == VIDEO_FPS,
          f"VideoReader took {reader.decoder} and read {len(frames)} of {n} frames of "
          f"{vb.HD_MKV} at {reader.fps} fps")
    for i, frame in enumerate(frames):
        check(hashlib.sha256(frame.cpu().numpy().tobytes()).hexdigest()
              == meta["rgb_sha256"][i], f"{vb.HD_MKV} frame {i} is not cv2's")
    bad, _ = vb.mpeg4_disagreements({vb.XVID_AVI: manifest[vb.XVID_AVI]["frames"]})
    check(bad == [], f"the XviD clip: {bad[:5]}")
    xvid_path = os.path.join(vb.VIDEO_SAMPLES, vb.XVID_AVI)
    xvid = mpeg4.Mpeg4Decoder(None, "cuda", codec_tag=open_movie(xvid_path).tag)
    xvid.decode(vb.movie_frames(xvid_path)[0])
    check(xvid.identity()["xvid_idct"], f"the XviD clip decoded with {xvid.identity()}")
    xvid.close()
    mjpeg = os.path.join(vb.VIDEO_SAMPLES, vb.MJPEG_MKV)
    bad = vb.reader_disagreements(mjpeg, vb.movie_frames(mjpeg),
                                  manifest[vb.MJPEG_MKV]["fps"], "cuda")
    check(bad == [], f"the V_MJPEG clip: {bad[:5]}")
    demux = vb.demux_ms(clip)
    idct = vb.idct_ms(vb.HD_MKV)
    checks_s = time.perf_counter() - t_leg
    counts = res["counts"]
    check(counts == {"greedy_nms": n, "head_scores": n},
          f"the mkv video demo launched {counts}, not one of each a frame")
    check(len(res["detections"]) == n and res["fps"] == VIDEO_FPS,
          f"the mkv demo read {len(res['detections'])} frames at {res['fps']} fps")
    movie = read_mkv(out_mkv)
    check((len(movie.frames), movie.fps, movie.width, movie.height, movie.codec_id)
          == (n, VIDEO_FPS, 1280, 720, "V_MPEG4/ISO/ASP"),
          f"out.mkv: {len(movie.frames)} frames of {movie.codec_id} at {movie.fps} fps")
    drawer = Drawing(list(COCO))
    encoder = mpeg4.Mp4vEncoder(1280, 720, VIDEO_FPS)
    check(movie.config == encoder.headers(), "out.mkv's CodecPrivate is not the encoder's VOL")
    back = mpeg4.Mpeg4Decoder(movie.config, "cuda")
    res_mp4, out_mp4 = mp4_run
    mp4 = read_mp4(out_mp4) if res["detections"] == res_mp4["detections"] else None
    n_det = 0
    with torch.backends.cudnn.flags(**tf32), open(out_mkv, "rb") as f, \
            open(out_mp4, "rb") as g:
        for i, (frame, got) in enumerate(zip(frames, res["detections"])):
            got = np.asarray(got, np.float32).reshape(-1, 6)
            w, _ = pred(frame)
            check(got.shape[1:] == (6,) and np.isfinite(got).all(),
                  f"mkv frame {i}: non-finite or misshapen detections")
            check(same_detections(w, got, 1e-5, 1e-3),
                  f"mkv frame {i}: {len(got)} detections against in-process {len(w)}")
            data = movie.read_frame(f, i)
            if mp4 is not None:
                check(data == mp4.read_frame(g, i)
                      and movie.keyframes[i] == (i in set(mp4.keyframes)),
                      f"out.mkv frame {i} is not out.mp4's VOP of the same drawn frame")
            else:
                vop, key = encoder.encode(drawer.draw(frame.cpu().numpy(), got))
                check(data == vop and movie.keyframes[i] == key,
                      f"out.mkv frame {i} is not Mp4vEncoder's VOP of the drawn frame")
                planes = back.decode(data)
                check(all(np.array_equal(p, q[:p.shape[0], :p.shape[1]])
                          for p, q in zip(planes, encoder.recon)),
                      f"out.mkv frame {i} does not read back as the encoder's "
                      "reconstruction")
            n_det += len(got)
    back.close()
    check(n_det > 0, "the mkv video demo found no detections")
    ms = {k: float(np.median(v)) for k, v in res["ms"].items()}
    print(f"demo: Matroska and XviD on data/video_samples/: {vb.HD_MKV} (cv2's mp4v in "
          f"Matroska) through VideoReader and the host C++ decoder, every frame at cv2's "
          f"sha256; {vb.XVID_AVI} (tagged XVID, no user data) through the C++ decoder's "
          f"XviD IDCT at cv2's sha256 and bit-equal to the plain decoder; {vb.MJPEG_MKV} "
          f"(V_MJPEG) through nvJPEG within NVJPEG_TOLERANCE, threaded = unthreaded "
          f"({checks_s:.1f} s); Matroska demux {demux:.4f} ms a frame (index and read, "
          f"host clock); a 720x1280 VOP by the C++ decoder (median ms): simple IDCT I "
          f"{idct['simple']['I']:.2f}, P {idct['simple']['P']:.2f}; XviD IDCT I "
          f"{idct['xvid']['I']:.2f}, P {idct['xvid']['P']:.2f} on {smi}", flush=True)
    print(f"demo: python -m vision_kit_tpu_torch demo -p {vb.HD_MKV} -o out.mkv (v5s@640 f32, "
          f"{n} frames of 720x1280 mp4v in Matroska at {VIDEO_FPS:g} fps, the host C++ "
          f"decoder): {n_det} detections, each frame equal to an in-process Predictor's "
          f"(class exact, score 1e-5, box 1e-3 px), launches {counts}; out.mkv "
          f"({os.path.getsize(out_mkv)} B) every block Mp4vEncoder's VOP of the drawn frame, "
          f"CodecPrivate its VOL, read back equal to its reconstruction ("
          f"{'as out.mp4, the same detections' if mp4 is not None else 'encoded here'}); "
          f"median ms a frame "
          f"(host clock): read/decode {ms['read']:.3f}, predict {ms['predict']:.3f}, draw "
          f"{ms['draw']:.3f}, encode {ms['encode']:.3f}; {n / res['wall_s']:.2f} fps over "
          f"the loop ({1000 * res['wall_s'] / n:.1f} ms a frame, {res['wall_s']:.2f} s), the "
          f"run {res['run_s']:.1f} s; the mkv leg "
          f"{time.perf_counter() - t_leg + res['run_s']:.1f} s on {smi}",
          flush=True)
    return counts


def vpx_leg(kind: str, res: dict, pred, tf32: dict, smi: str) -> dict:
    """The demo's video mode on VP8 or VP9 (`kind` "vp8" or "vp9"): the
    committed clips (data/video_samples/, cv2's VP80 or VP90 in WebM; the
    VP9 720p one in four tile columns) through the nvcc-built host C++
    decoder, every frame's RGB on the card at the sha256 of cv2's frame,
    the small clip's planes bit-equal to the plain decoder's, the ms a 720p
    key and inter frame (best of 3) and a small frame by the plain decoder
    (video_bench.vp8_disagreements, vp9_disagreements); the 720p clip
    through VideoReader (the "host_cpp" route) at cv2's sha256 again; then
    `res`, the run of `demo -p vp8_720x1280_12f.webm` or
    `vp9_720x1280_12f.webm` (no -o) in the --demo-video child: one launch
    of each kernel a frame, each frame's detections equal to an in-process
    Predictor's on the same decoded frame. Returns the run's launches."""
    import hashlib
    import importlib

    from vision_kit_tpu_torch.utils import video_bench as vb
    from vision_kit_tpu_torch.utils.readers import VideoReader
    from vision_kit_tpu_torch.utils.stream_bench import same_detections

    codec = importlib.import_module(f"vision_kit_tpu_torch.data.{kind}")
    name, hd, small = kind.upper(), getattr(vb, f"{kind.upper()}_HD"), getattr(
        vb, f"{kind.upper()}_SMALL")
    t_leg = time.perf_counter()
    calls = codec.c_calls()
    bad, ms = getattr(vb, f"{kind}_disagreements")("cuda")
    check(bad == [], f"the {name} decoders: {bad[:5]}")
    meta = vb.video_manifest()[hd]
    n = meta["frames"]
    reader = VideoReader(os.path.join(vb.VIDEO_SAMPLES, hd), use_thread=False)
    frames = [fr for ok, fr in reader if ok]
    check(reader.decoder == "host_cpp" and len(frames) == n and reader.fps == meta["fps"]
          and codec.c_calls() > calls, f"VideoReader took {reader.decoder} and read "
          f"{len(frames)} of {n} frames of {hd} at {reader.fps} fps")
    for i, frame in enumerate(frames):
        check(hashlib.sha256(frame.cpu().numpy().tobytes()).hexdigest()
              == meta["rgb_sha256"][i], f"{hd} frame {i} is not cv2's")
    checks_s = time.perf_counter() - t_leg
    counts = res["counts"]
    check(counts == {"greedy_nms": n, "head_scores": n},
          f"the {kind} video demo launched {counts}, not one of each a frame")
    check(len(res["detections"]) == n and res["fps"] == meta["fps"],
          f"the {kind} demo read {len(res['detections'])} frames at {res['fps']} fps")
    n_det = 0
    with torch.backends.cudnn.flags(**tf32):
        for i, (frame, got) in enumerate(zip(frames, res["detections"])):
            got = np.asarray(got, np.float32).reshape(-1, 6)
            w, _ = pred(frame)
            check(got.shape[1:] == (6,) and np.isfinite(got).all(),
                  f"{kind} frame {i}: non-finite or misshapen detections")
            check(same_detections(w, got, 1e-5, 1e-3),
                  f"{kind} frame {i}: {len(got)} detections against in-process {len(w)}")
            n_det += len(got)
    check(n_det > 0, f"the {kind} video demo found no detections")
    stage = {k: float(np.median(v)) for k, v in res["ms"].items()}
    print(f"demo: the {name} decoders on data/video_samples/ (cv2's {name[:2]}{name[2]}0 in "
          f"WebM): the host C++ decoder's RGB (yuv420_to_rgb on the card) at cv2's sha256 on "
          f"every frame of {hd} (through VideoReader too) and {small}, its planes bit-equal "
          f"to the plain decoder's on {small} ({checks_s:.1f} s); host-clock ms a "
          f"frame: C++ 720x1280 key {ms['cpp']['key']:.2f}, inter {ms['cpp']['inter']:.2f} "
          f"(best of 3); plain 144x176 key {ms['plain']['key']:.1f}, inter "
          f"{ms['plain']['inter']:.1f} on {smi}", flush=True)
    print(f"demo: python -m vision_kit_tpu_torch demo -p {hd} (v5s@640 f32, {n} "
          f"frames of 720x1280 {name} at {meta['fps']:g} fps, the host C++ decoder, no -o): "
          f"{n_det} detections, each frame equal to an in-process Predictor's (class exact, "
          f"score 1e-5, box 1e-3 px), launches {counts}; median ms a frame (host clock): "
          f"read/decode {stage['read']:.3f}, predict {stage['predict']:.3f}, draw "
          f"{stage['draw']:.3f}; {n / res['wall_s']:.2f} fps over the loop "
          f"({res['wall_s']:.2f} s), the run {res['run_s']:.1f} s; the {kind} leg "
          f"{time.perf_counter() - t_leg + res['run_s']:.1f} s on {smi}", flush=True)
    return counts


def tags_leg(res: dict, pred, tf32: dict, smi: str) -> dict:
    """The demo's video mode on the tags and containers of the port's codecs
    (data/video_samples/tags/, cv2's files: Motion-JPEG in MP4, QuickTime,
    AVI as JPGL and raw .mjpeg, XVID in QuickTime, PNG and Motion JPEG 2000
    frames in AVI, Matroska, MP4 and QuickTime, raw I420, Y800 and RGBA in
    AVI, Matroska, QuickTime and YUV4MPEG2, a UYVY AVI of no frame):
    video_bench.tag_disagreements on the card (VideoReader threaded and
    unthreaded: cv2's count and fps, the plain CPU read at the manifest's
    sha256, the card's frames equal to it, nvJPEG's within its tolerance,
    the Motion JPEG 2000 frames by the C++ twin's video mode), each file's
    route and seconds on a line of its own; then `res`, the run of `demo -p
    mjp2_64x96.mov` (no -o) in the --demo-video child: one launch of each
    kernel a frame, each frame's detections equal to an in-process
    Predictor's on the frame the reader gives. Returns the run's launches."""
    from vision_kit_tpu_torch.data import decode as dec
    from vision_kit_tpu_torch.data import jp2
    from vision_kit_tpu_torch.utils import video_bench as vb
    from vision_kit_tpu_torch.utils.readers import VideoReader
    from vision_kit_tpu_torch.utils.stream_bench import same_detections

    t_leg = time.perf_counter()
    before, stills = dict(jp2.video_counts), dec.route_counts["host_jp2"]
    bad, info = vb.tag_disagreements("cuda")
    check(bad == [], f"the tag fixtures: {bad[:5]}")
    for name, row in info.items():
        print(f"demo: tags: {name} ({row['codec']}): route {row['route']}, {row['frames']} "
              f"frames as cv2 reads them, {row['s']:.2f} s (the plain read on the CPU, then "
              f"the card's threaded and unthreaded) on {smi}", flush=True)
    twin = {k: jp2.video_counts[k] - before[k] for k in before}
    check(twin["host_cpp"] > 0 and dec.route_counts["host_jp2"] == stills,
          f"the JPEG 2000 video mode's decodes {twin}, still-image host_jp2 "
          f"{dec.route_counts['host_jp2'] - stills}")
    checks_s = time.perf_counter() - t_leg
    print(f"demo: tags: {len(info)} files, cv2's count, fps and frames (bit-equal, or "
          f"nvJPEG within NVJPEG_TOLERANCE); JPEG 2000 video-mode decodes (jp2.video_counts) "
          f"{twin}, still-image route host_jp2 +0; {checks_s:.1f} s on {smi}", flush=True)
    meta = vb.tag_manifest()[vb.MJ2_MOV]
    n = meta["read"]
    counts = res["counts"]
    check(counts == {"greedy_nms": n, "head_scores": n},
          f"the Motion JPEG 2000 video demo launched {counts}, not one of each a frame")
    check(len(res["detections"]) == n and res["fps"] == meta["fps"],
          f"the Motion JPEG 2000 demo read {len(res['detections'])} frames at {res['fps']} fps")
    reader = VideoReader(os.path.join(vb.TAG_SAMPLES, vb.MJ2_MOV), use_thread=False)
    frames = [fr for ok, fr in reader if ok]
    check(reader.decoder == "host_cpp" and len(frames) == n,
          f"VideoReader took {reader.decoder} and read {len(frames)} of {n} frames")
    n_det = 0
    with torch.backends.cudnn.flags(**tf32):
        for i, (frame, got) in enumerate(zip(frames, res["detections"])):
            got = np.asarray(got, np.float32).reshape(-1, 6)
            w, _ = pred(frame)
            check(got.shape[1:] == (6,) and np.isfinite(got).all(),
                  f"mj2 frame {i}: non-finite or misshapen detections")
            check(same_detections(w, got, 1e-5, 1e-3),
                  f"mj2 frame {i}: {len(got)} detections against in-process {len(w)}")
            n_det += len(got)
    stage = {k: float(np.median(v)) for k, v in res["ms"].items()}
    print(f"demo: python -m vision_kit_tpu_torch demo -p {vb.MJ2_MOV} (v5s@640 f32, {n} "
          f"frames of 64x96 Motion JPEG 2000 at {meta['fps']:g} fps, the C++ twin's video "
          f"mode, no -o): {n_det} detections, each frame equal to an in-process "
          f"Predictor's (class exact, score 1e-5, box 1e-3 px), launches {counts}; median ms "
          f"a frame (host clock): read/decode {stage['read']:.3f}, predict "
          f"{stage['predict']:.3f}, draw {stage['draw']:.3f}; {n / res['wall_s']:.2f} fps over "
          f"the loop ({res['wall_s']:.2f} s), the run {res['run_s']:.1f} s; the tags leg "
          f"{time.perf_counter() - t_leg + res['run_s']:.1f} s on {smi}", flush=True)
    return counts


def demo_video_child(weights: str, *paths: str) -> list:
    """`python -m vision_kit_tpu_torch demo -p clip -o out -w weights` for
    each (clip, out) pair of `paths` in turn (an out of "-": no -o),
    through the CLI's main in this process (one interpreter and CUDA
    context for every run), with the kernels' launches counted around each
    run, its printing and seconds kept, and demo_video's result."""
    from vision_kit_tpu_torch import __main__ as cli

    out = []
    run = cli.demo_video
    for clip, path in zip(paths[::2], paths[1::2]):
        results = []
        cli.demo_video = lambda *a, **kw: results.append(run(*a, **kw)) or results[-1]
        printed = io.StringIO()
        t0 = time.perf_counter()
        reset_counts()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["demo", "-p", clip, "-w", weights]
                          + (["-o", path] if path != "-" else []))
        counts = read_counts()
        (res,) = results
        out.append({"rc": rc, "counts": counts, "fps": res["fps"], "ms": res["ms"],
                    "wall_s": res["wall_s"], "run_s": time.perf_counter() - t0,
                    "printed": printed.getvalue()[-2000:],
                    "detections": [d.tolist() for d in res["detections"]]})
    cli.demo_video = run
    return out


def video_runs(weights: str, pairs: list) -> tuple:
    """The demo's video runs, each (clip, out) of `pairs`, in one
    --demo-video child (its kernels' launches counted there): ([each run's
    result], the child's seconds)."""
    import subprocess

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"), "--demo-video",
                        weights, *(p for pair in pairs for p in pair)], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("VIDEO ")]
    check(r.returncode == 0 and lines,
          f"the video demo child exited {r.returncode}: {r.stderr[-3000:]}")
    runs = json.loads(lines[-1][len("VIDEO "):])
    check(len(runs) == len(pairs) and all(run["rc"] == 0 for run in runs),
          f"the video demo child ran {[run['rc'] for run in runs]}")
    return runs, child_s


SERVE_BATCH = 8


def undefined_table_jpeg(data: bytes) -> bytes:
    """`data` with its scan's first component pointed at Huffman tables 3,
    which no DHT defines: the host C walk cannot read it, so it decodes on
    the host (None) and never reaches nvJPEG."""
    sos = data.index(b"\xff\xda")
    return data[:sos + 6] + bytes([0x33]) + data[sos + 7:]


def without_huffman_tables(data: bytes) -> bytes:
    """`data` with its DHT segments dropped, as a Motion-JPEG camera writes
    a frame: libjpeg takes the standard tables, so does the port."""
    from vision_kit_tpu_torch.data import decode as dec

    out = bytearray(data[:2])
    for m, a, b, end in dec._walk(data):
        if m == dec.EOI:
            out += data[a - 2:a]
        elif m != dec.DHT:
            out += data[a - 4:end if m == dec.SOS else b]
    return bytes(out)


def undefined_quant_jpeg(data: bytes) -> bytes:
    """`data` with its first component pointed at quantization table 3,
    which no DQT defines: the header check and the C walk (neither reads
    quantization tables) pass it to nvJPEG, which must refuse it, as the
    plain decoder does."""
    from vision_kit_tpu_torch.data import decode as dec

    sof = next(a for m, a, _, _ in dec._walk(data) if m in dec.SOF_HUFFMAN)
    return data[:sof + 8] + bytes([3]) + data[sof + 9:]


def post(url: str, data: bytes, timeout: float = 60.0):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def no_dht_legs(smi: str) -> None:
    """JPEGs without Huffman tables on the card: the committed DHT-less 720p
    frame and the optimised-slot-0 sample route to nvJPEG, which decodes
    them (the standard tables spliced in before it) within its tolerance of
    the plain decoder (checked with every sample); nvJPEG's own answer to
    the bytes without the splice (recorded); the reduced decodes equal the
    spliced file's; the ms of a DHT-less nvJPEG decode beside the
    baseline frame's; VideoReader on the card plays a Motion-JPEG AVI of the
    720p frames without their DHTs to its last frame, nvJPEG within its
    tolerance of the plain decoder, one nvJPEG decode a frame."""
    import tempfile

    from vision_kit_tpu_torch.data import decode as dec
    from vision_kit_tpu_torch.utils import serve_bench as svb
    from vision_kit_tpu_torch.utils.avi import AviWriter
    from vision_kit_tpu_torch.utils.readers import VideoReader

    t0 = time.perf_counter()
    nodht = svb.sample_bytes("jpeg_no_dht")[0]
    for kind in ("jpeg_no_dht", "jpeg_std_slot1"):
        data = svb.sample_bytes(kind)[0]
        calls = dec.decode_jpeg_cuda.calls
        check(dec.decode_route(data, "cuda") == "nvjpeg" and dec.scans_short(data) == [0]
              and dec.walk_scans_short(data) == [0]
              and dec.decode_to(data, "cuda") is not None
              and dec.decode_jpeg_cuda.calls == calls + 1,
              f"serve: a {kind} sample did not decode through nvJPEG")
    info = dec.jpeg_header(nodht)
    spliced = dec.with_standard_tables(nodht, info)
    for f in (2, 4, 8):
        check(np.array_equal(dec.decode_jpeg_reduced(nodht, f),
                             dec.decode_jpeg_reduced(spliced, f)),
              f"serve: the DHT-less frame's 1/{f} decode differs from the spliced file's")
    raw = dec._decoder(torch.device("cuda", 0)).decode(nodht, 3)
    torch.cuda.synchronize()
    raw_agree = None if raw is None else dec.pixel_agreement(raw, dec.decode_image(nodht))
    ms = {"no DHT": svb.decode_ms(lambda d: dec.decode_to(d, "cuda"), [nodht], "cuda", reps=10),
          "baseline": svb.decode_ms(lambda d: dec.decode_to(d, "cuda"),
                                    svb.sample_bytes("jpeg_720p")[:1], "cuda", reps=10)}
    print(f"serve: JPEGs without Huffman tables (a 720x1280 frame with no DHT, a "
          f"240x320 one with an optimised slot 0 and no slot 1) on nvjpeg, the C walk "
          f"and scans_short [0]; the frame's 1/2, 1/4, 1/8 decodes equal the spliced "
          f"file's; nvJPEG on the frame's bytes as they are, without the splice: "
          + ("refused (None)" if raw is None else f"decoded, max |d| {raw_agree['max_abs']}, "
             f"mean |d| {raw_agree['mean_abs']:.4f} against the plain decoder")
          + f"; decode_to ms (host clock, synchronised): no DHT {ms['no DHT']:.3f}, the "
          f"baseline frame {ms['baseline']:.3f} on {smi}", flush=True)
    frames = [without_huffman_tables(d) for d in svb.sample_bytes("jpeg_720p")]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "nodht.avi")
        with AviWriter(path, 30.0) as writer:
            for data in frames * 2:
                writer.write(data, 1280, 720)
        calls = dec.decode_jpeg_cuda.calls
        reader = VideoReader(path, device="cuda")
        got = [frame for ok, frame in reader if ok]
        reader.stop()
        check(len(got) == len(reader) == 2 * len(frames)
              and dec.decode_jpeg_cuda.calls == calls + len(got),
              f"serve: VideoReader played {len(got)} of {len(reader)} DHT-less frames")
        worst = {"max_abs": 0, "mean_abs": 0.0}
        for frame, data in zip(got, frames * 2):
            agree = dec.pixel_agreement(frame, dec.decode_image(data))
            check(dec.within_nvjpeg_tolerance(agree),
                  f"serve: a DHT-less video frame outside nvJPEG's tolerance: {agree}")
            worst = {k: max(worst[k], agree[k]) for k in worst}
    print(f"serve: a Motion-JPEG AVI of the 720x1280 frames without DHTs "
          f"({len(got)} frames): VideoReader on the card played it to its last frame, "
          f"one nvJPEG decode a frame, worst max |d| {worst['max_abs']}, mean |d| "
          f"{worst['mean_abs']:.4f} against the plain decoder; the DHT-less legs "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def eoi_less_leg(smi: str) -> None:
    """frame1_720x1280_420_q90.jpg without its EOI (2 bytes short): one scan
    that the bytes end inside, which libjpeg decodes whole as its bit buffer
    never reads past them. Its route is "host_cut" from the header, the card
    decodes it on the host bit-equal to the plain decoder (and to the whole
    file), and nvJPEG never sees it; 5 bytes short, libjpeg would suspend:
    None on both."""
    from vision_kit_tpu_torch.data import decode as dec
    from vision_kit_tpu_torch.utils import serve_bench as svb

    whole = next(d for n, _, d in svb.samples() if n == "frame1_720x1280_420_q90.jpg")
    calls = dec.decode_jpeg_cuda.calls
    t0 = time.perf_counter()
    cut, shorter = whole[:-2], whole[:-5]
    route = dec.decode_route(cut, "cuda")
    got, want = dec.decode_to(cut, "cuda"), dec.decode_image(cut)
    ms = (time.perf_counter() - t0) * 1e3
    check(route == "host_cut" and got is not None and want is not None
          and torch.equal(got.cpu(), torch.from_numpy(want))
          and np.array_equal(want, dec.decode_image(whole)),
          f"serve: frame1 without its EOI: route {route}, card {got is not None}, "
          f"host {want is not None}")
    check(dec.decode_route(shorter, "cuda") == "host_cut"
          and dec.decode_to(shorter, "cuda") is None and dec.decode_image(shorter) is None,
          "serve: frame1 5 bytes short decoded; libjpeg suspends for it")
    check(dec.decode_jpeg_cuda.calls == calls, "serve: an EOI-less JPEG reached nvJPEG")
    print(f"serve: frame1_720x1280_420_q90.jpg without its EOI ({len(cut)} B): route "
          f"{route}, card against plain bit-equal, equal to the whole file, nvJPEG not "
          f"called, route and host decode {ms:.1f} ms; 5 bytes short: None on both "
          f"(libjpeg suspends) on {smi}", flush=True)


def serve_decode(smi: str) -> dict:
    """Each sample decoded on the card (decode_to, by the route its header
    picks) against the plain decoder on the host, refusals alike: the
    nvJPEG routes (baseline and progressive) within NVJPEG_TOLERANCE, the
    host routes (a progressive file that ends early, CMYK, YCCK, RGB, PNG,
    BMP, WebP) bit-equal, each WebP at its manifest's rgb_sha256 (cv2's
    pixels; the card's machine has no cv2); the host C walk of every JPEG
    (csrc/jpeg_walk.cu) equal to scans_short, its ms on the 720p baseline
    and progressive frames; a progressive and a baseline sample cut inside
    their last scan and closed by an EOI on "host_cut", bit-equal to the
    plain decoder, where nvJPEG took them before the walk; a 40000x40000
    SOF "refused" without reaching nvJPEG; the count of each route; one
    720x1280 progressive decode timed by nvJPEG and by the plain decoder
    beside the baseline frame's, the plain WebP decode at 240x320 lossy and
    lossless and of the 117x163 arithmetic-coded and lossless JPEGs, each
    of those JPEGs at its manifest's rgb_sha256 on "host_arith" or
    "host_lossless"; the 720x1280 frame without its EOI on "host_cut"
    (eoi_less_leg); a corrupt JPEG refused by nvJPEG and the next decode
    still right, a host-route JPEG never handed to nvJPEG, letterbox_u8
    equal on the card and the CPU. Returns the card's decoded frames by
    file name."""
    import hashlib

    from vision_kit_tpu_torch import _cuda_build
    from vision_kit_tpu_torch.data import decode as dec
    from vision_kit_tpu_torch.ops.letterbox import letterbox_u8
    from vision_kit_tpu_torch.utils import serve_bench as svb

    header, lib = _cuda_build.nvjpeg_paths()
    print(f"serve: nvjpeg.h {header}, libnvjpeg.so {lib}, nvJPEG "
          f"{dec.nvjpeg_version()}", flush=True)
    frames = {}
    dec.route_counts.update(dict.fromkeys(dec.route_counts, 0))
    for name, meta, data in svb.samples():
        # JPEG 2000 by its host C++ twin, as the server on the card decodes it
        # (jp2_leg holds it to the plain decoder)
        want = dec.decode_image(data, native=meta["kind"].startswith("jp2"))
        route = dec.decode_route(data, "cuda")
        got = dec.decode_to(data, "cuda", host_decode=lambda _: want)   # one host decode
        if "rgb_sha256" in meta:   # WebPs, arithmetic-coded and lossless JPEGs
            check(route.startswith("host_") and got is not None and hashlib.sha256(
                got.cpu().numpy().tobytes()).hexdigest() == meta["rgb_sha256"],
                f"serve: {name} on {route} is not cv2's decode (rgb_sha256)")
        if meta["shape"] is None:
            check(want is None and got is None,
                  f"serve: {name} ({meta['kind']}) decoded; both devices must refuse it")
            print(f"serve: {name} ({meta['kind']}) refused on the card and on the host "
                  f"(route {route})", flush=True)
            continue
        check(want is not None and got is not None, f"serve: {name} not decoded")
        check(tuple(got.shape) == want.shape == (*meta["shape"], 3),
              f"serve: {name} decoded to {tuple(got.shape)} / {want.shape}, "
              f"manifest {meta['shape']}")
        agree = dec.pixel_agreement(got, want)
        if route.startswith("nvjpeg"):
            print(f"serve: {name} ({meta['kind']}, {meta['bytes']} B, route {route}) card "
                  f"against plain: max |d| {agree['max_abs']}, mean |d| "
                  f"{agree['mean_abs']:.4f}, share |d| > 2 {agree['share_over_2']:.6f}",
                  flush=True)
            check(dec.within_nvjpeg_tolerance(agree), f"serve: {name}: nvJPEG "
                  f"outside its tolerance {dec.NVJPEG_TOLERANCE}")
        else:   # a host route: one plain decode, which decode_to moves to the card
            print(f"serve: {name} ({meta['kind']}, {meta['bytes']} B, route {route}) one "
                  f"plain decode on the host, on the card as decoded: max |d| "
                  f"{agree['max_abs']}", flush=True)
            check(agree["max_abs"] == 0, f"serve: {name} ({route}) changed on its way "
                  "to the card")
        frames[name] = got
    t_new = time.perf_counter()
    for kind, route in (("jpeg_arith", "host_arith"), ("jpeg_lossless", "host_lossless"),
                        *((k, f"host_{k}") for k in dec.MODULE_KINDS)):
        names = [n for n, m, _ in svb.samples() if "rgb_sha256" in m
                 and m["kind"].startswith(kind)]
        check(names, f"serve: no {kind} sample")
        print(f"serve: {len(names)} {kind} samples on {route}, each equal to its "
              f"manifest's rgb_sha256 (cv2.imdecode + BGR2RGB): {', '.join(names)}",
              flush=True)
    eoi_less_leg(smi)
    # the host C walk against the plain decoder's walks, and what it costs
    cases = svb.walk_cases()
    bad = svb.walk_disagreements(cases, "cuda")
    check(not bad, "serve: the C walk disagrees with scans_short: " + "; ".join(bad[:5]))
    walk_ms = {}
    for kind in ("jpeg_720p", "jpeg_progressive_720p"):
        data = svb.sample_bytes(kind)[0]
        dec.walk_scans_short(data)
        t0 = time.perf_counter()
        for _ in range(20):
            dec.walk_scans_short(data)
        walk_ms[kind] = (time.perf_counter() - t0) * 1e3 / 20
    print(f"serve: the C walk (csrc/jpeg_walk.cu, host) equals scans_short on "
          f"{len(cases)} JPEGs (every sample, each cut inside its last scan, the restart "
          f"sample cut at RST markers); host ms a walk: 720x1280 baseline "
          f"{walk_ms['jpeg_720p']:.3f}, 720x1280 progressive "
          f"{walk_ms['jpeg_progressive_720p']:.3f} on {smi}", flush=True)
    for kind in ("jpeg_progressive", "jpeg_720p"):
        # a cut inside the last scan: the header reads complete, the walk
        # finds the MCUs short of bits, and the host decodes the file
        cut = svb.cut_inside_last_scan(svb.sample_bytes(kind)[0])
        route = dec.decode_route(cut, "cuda")
        calls = dec.decode_jpeg_cuda.calls
        got, want = dec.decode_to(cut, "cuda"), dec.decode_image(cut)
        check(route == "host_cut" and got is not None and want is not None
              and dec.decode_jpeg_cuda.calls == calls
              and torch.equal(got.cpu(), torch.from_numpy(want)),
              f"serve: a {kind} sample cut inside its last scan: route {route}, "
              f"card {got is not None}, host {want is not None}")
        agree = dec.pixel_agreement(got, want)
        print(f"serve: a {kind} sample cut halfway through its last scan, EOI "
              f"appended ({len(cut)} B): route {route}, scans short "
              f"{dec.scans_short(cut)}, card against plain: max |d| {agree['max_abs']}, "
              f"mean |d| {agree['mean_abs']:.4f}", flush=True)
    no_dht_legs(smi)
    big = svb.sample_bytes("jpeg_444")[0]
    sof = next(a for m, a, _, _ in dec._walk(big) if m in dec.SOF_ALL)
    big = big[:sof + 1] + (40000).to_bytes(2, "big") * 2 + big[sof + 5:]
    calls = dec.decode_jpeg_cuda.calls
    check(dec.decode_route(big, "cuda") == "refused" and dec.decode_to(big, "cuda") is None
          and dec.decode_jpeg_cuda.calls == calls,
          "serve: a 40000x40000 SOF was not refused before nvJPEG")
    print(f"serve: a {len(big)} B JPEG whose SOF claims 40000x40000 (over OpenCV's "
          f"1 << 30 pixels): route refused, decode_to None, nvJPEG not called", flush=True)
    routes = dict(dec.route_counts)
    check(all(routes[r] > 0 for r in dec.ROUTES if r != "host_jpeg"),
          f"serve: a route took no sample: {routes}")
    print(f"serve: routes, one decode of each sample, the two cut files and the "
          f"oversize SOF: {json.dumps(routes)}", flush=True)
    by_name = {n: d for n, _, d in svb.samples()}
    webp_ms = {kind: svb.decode_ms(dec.decode_image, [by_name[f"{kind}_240x320.webp"]],
                                   "cpu", reps=3) for kind in ("lossy", "lossless")}
    print(f"serve: one 240x320 WebP decode by the plain decoder (host clock, ms): lossy "
          f"{webp_ms['lossy']:.3f}, lossless {webp_ms['lossless']:.3f} on {smi}", flush=True)
    jpeg_ms = {name: svb.decode_ms(dec.decode_image, [by_name[name]], "cpu", reps=3)
               for name in ("arith_420_rst3_117x163.jpg", "arith_progressive_117x163.jpg",
                            "lossless_p1_117x163.jpg", "lossless_p7_117x163.jpg")}
    print("serve: one 117x163 JPEG decode by the plain decoder (host clock, ms): "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in jpeg_ms.items()) + f" on {smi}",
          flush=True)
    image_kinds_leg(routes, smi)
    print(f"serve: the WebP, C walk, cut and oversize legs took "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)
    progressive = svb.sample_bytes("jpeg_progressive_720p")
    baseline = svb.sample_bytes("jpeg_720p")[:1]
    t_prog = {"nvjpeg": svb.decode_ms(lambda d: dec.decode_to(d, "cuda"), progressive,
                                      "cuda", reps=5),
              "plain": svb.decode_ms(dec.decode_image, progressive, "cpu", reps=2)}
    t_base = {"nvjpeg": svb.decode_ms(lambda d: dec.decode_to(d, "cuda"), baseline,
                                      "cuda", reps=5),
              "plain": svb.decode_ms(dec.decode_image, baseline, "cpu", reps=2)}
    print(f"serve: one 720x1280 decode (host clock, synchronised, ms): progressive "
          f"nvJPEG {t_prog['nvjpeg']:.3f}, plain {t_prog['plain']:.3f}; baseline nvJPEG "
          f"{t_base['nvjpeg']:.3f}, plain {t_base['plain']:.3f} on {smi}", flush=True)
    calls = dec.decode_jpeg_cuda.calls
    for kind in ("jpeg_progressive_early", "jpeg_cmyk"):
        check(dec.decode_jpeg_cuda(svb.sample_bytes(kind)[0], "cuda") is None
              and dec.decode_jpeg_cuda.calls == calls,
              f"serve: a {kind} sample reached nvJPEG")
    good = next(d for n, m, d in svb.samples() if m["kind"] == "jpeg_720p")
    calls = dec.decode_jpeg_cuda.calls
    check(dec.decode_to(undefined_table_jpeg(good), "cuda") is None
          and dec.decode_image(undefined_table_jpeg(good)) is None
          and dec.decode_jpeg_cuda.calls == calls,
          "serve: a scan naming an undefined Huffman table decoded or reached nvJPEG")
    check(dec.decode_to(undefined_quant_jpeg(good), "cuda") is None
          and dec.decode_image(undefined_quant_jpeg(good)) is None,
          "serve: a component naming an undefined quantization table decoded")
    check(dec.decode_jpeg_cuda.calls == calls + 1,
          "serve: the corrupt JPEG did not reach nvJPEG")
    check(dec.decode_to(b"\xff\xd8garbage body", "cuda") is None,
          "serve: garbage bytes decoded")
    after = dec.decode_to(good, "cuda")
    torch.cuda.synchronize()
    check(after is not None and torch.equal(after, frames["frame0_720x1280_420_q90.jpg"]),
          "serve: the decode after a corrupt JPEG differs")
    print("serve: a scan naming an undefined Huffman table stopped at the C walk "
          "(host route, None); nvJPEG refused a component naming an undefined "
          "quantization table "
          "(None, as on the host), garbage bytes gave None, and the next decode "
          "equals the first (no CUDA error left); decode_jpeg_cuda handed no "
          "host-route JPEG to nvJPEG", flush=True)
    for name, img in frames.items():
        a, ra = letterbox_u8(img, 640)
        b, rb = letterbox_u8(img.cpu(), 640)
        check(torch.equal(a.cpu(), b) and ra == rb,
              f"serve: letterbox_u8 of {name} differs between the card and the CPU")
    print(f"serve: letterbox_u8 to 640 bit-equal on the card and the CPU for "
          f"{len(frames)} decoded samples", flush=True)
    return frames


def lzw_literal_tiff(rgb: np.ndarray) -> bytes:
    """A one-strip RGB TIFF whose LZW stream codes every byte as a literal:
    clear, 250 literals, clear, ..., end, all 9-bit codes, MSB first."""
    import struct

    flat = rgb.reshape(-1).astype(np.uint16)
    n = len(flat)
    clears = np.arange(0, n, 250)
    codes = np.insert(flat, clears, 256)
    codes = np.append(codes, 257)
    bits = ((codes[:, None] >> np.arange(8, -1, -1)) & 1).astype(np.uint8).reshape(-1)
    data = np.packbits(bits).tobytes()
    h, w = rgb.shape[:2]
    entries = [(256, 4, w), (257, 4, h), (258, 3, 8), (259, 3, 5), (262, 3, 2),
               (273, 4, 8), (277, 3, 3), (278, 4, h), (279, 4, len(data))]
    ifd = 8 + len(data) + (len(data) & 1)
    out = b"II*\0" + struct.pack("<I", ifd) + data + b"\0" * (len(data) & 1)
    out += struct.pack("<H", len(entries))
    for tag, typ, value in entries:   # BitsPerSample 8 once: libtiff takes it for all
        out += struct.pack("<HHI", tag, typ, 1) + struct.pack("<I" if typ == 4 else "<HH",
                                                             *((value,) if typ == 4
                                                               else (value, 0)))
    return out + b"\0" * 4


def jp2_leg(smi: str) -> None:
    """JPEG 2000: on every committed sample the host C++ twin
    (csrc/j2k_decode.cu, built by nvcc) at its manifest's rgb_sha256 (cv2's
    pixels) or refusing where cv2 refuses, and on the small ones equal to
    the plain decoder (data/jp2.py), refusal messages included; the plain
    decoder's ms on each small sample (one decode) and the twin's on each
    720x1280 file (host clock, best of three)."""
    import hashlib

    from vision_kit_tpu_torch.data import jp2
    from vision_kit_tpu_torch.utils import serve_bench as svb

    def outcome(fn, data):
        try:
            return fn(data)[0]
        except jp2.Jp2Error as e:
            return str(e)

    t0 = time.perf_counter()
    calls = jp2.c_calls()
    plain_ms, twin_ms, n = {}, {}, 0
    for name, meta, data in svb.samples():
        if not meta["kind"].startswith("jp2"):
            continue
        n += 1
        got = outcome(jp2.decode_jp2_c, data)
        if meta["shape"] is None:
            check(isinstance(got, str), f"jp2: {name} decoded by the twin; cv2 refuses it")
        else:
            check(not isinstance(got, str) and hashlib.sha256(got.tobytes()).hexdigest()
                  == meta["rgb_sha256"], f"jp2: {name} by the twin is not cv2's decode")
        if meta["kind"] == "jp2_720p":
            best = float("inf")
            for _ in range(3):
                t = time.perf_counter()
                jp2.decode_jp2_c(data)
                best = min(best, (time.perf_counter() - t) * 1e3)
            twin_ms[name] = best
            continue
        t = time.perf_counter()
        ref = outcome(jp2.decode_jp2, data)
        plain_ms[name] = (time.perf_counter() - t) * 1e3
        same = (ref == got if isinstance(ref, str) or isinstance(got, str)
                else np.array_equal(ref, got))
        check(same, f"jp2: {name}: the twin and the plain decoder differ")
    check(jp2.c_calls() - calls == n + 3 * len(twin_ms), "jp2: the twin's call count")
    print(f"jp2: the host C++ twin (csrc/j2k_decode.cu) on {n} JPEG 2000 samples equals "
          f"the manifest's rgb_sha256 (cv2.imdecode + BGR2RGB), refusals alike, and the "
          f"plain decoder on the {len(plain_ms)} small ones", flush=True)
    for name, ms in twin_ms.items():
        print(f"jp2: one 720x1280 decode by the twin ({name}, host clock, best of 3): "
              f"{ms:.3f} ms on {smi}", flush=True)
    print("jp2: one decode of each small sample by the plain decoder (host clock, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in plain_ms.items()) + f" on {smi}",
          flush=True)
    print(f"jp2: the JPEG 2000 leg took {time.perf_counter() - t0:.1f} s", flush=True)


def image_kinds_leg(routes: dict, smi: str) -> None:
    """The still-image kinds of data/<kind>.py but WebP (Netpbm/PAM, PFM,
    Sun raster, HDR, GIF, TIFF, JPEG 2000): each route's count from
    serve_decode's one decode of every sample, and each sample's plain
    decode on the host (ms; the 720x1280 GIF and LZW TIFF with predictor 2
    once, the small ones best of three; JPEG 2000 in jp2_leg)."""
    from vision_kit_tpu_torch.data import decode as dec
    from vision_kit_tpu_torch.utils import serve_bench as svb

    t0 = time.perf_counter()
    kinds = [k for k in dec.MODULE_KINDS if k != "webp"]
    counts = {f"host_{k}": routes[f"host_{k}"] for k in kinds}
    check(all(counts.values()), f"serve: an image kind's route took no sample: {counts}")
    print(f"serve: image kinds' routes, one decode_to each on the card: "
          f"{json.dumps(counts)}", flush=True)
    jp2_leg(smi)
    ms = {}
    for name, meta, data in svb.samples():
        if meta["kind"].split("_")[0] in kinds and meta["kind"].split("_")[0] != "jp2":
            big = meta["shape"] == [720, 1280]
            ms[name] = svb.decode_ms(dec.decode_image, [data], "cpu", reps=1 if big else 3)
    for kind in ("gif_720p", "tiff_720p"):
        name = next(n for n, m, _ in svb.samples() if m["kind"] == kind)
        print(f"serve: one 720x1280 {kind[:-5].upper()} decode by the plain decoder "
              f"({name}, host clock): {ms[name]:.3f} ms on {smi}", flush=True)
    # LZW's worst case: every code a literal (a clear code every 250, so all
    # are 9 bits), one per byte of a 720x1280 RGB frame
    frame = dec.decode_image(svb.sample_bytes("tiff_720p")[0])
    worst = lzw_literal_tiff(frame)
    t_worst = time.perf_counter()
    got = dec.decode_image(worst)
    ms_worst = (time.perf_counter() - t_worst) * 1e3
    check(got is not None and np.array_equal(got, frame),
          "serve: the all-literal LZW TIFF does not decode to its pixels")
    print(f"serve: one 720x1280 LZW TIFF of literal codes only ({len(worst)} B, "
          f"{frame.size} codes, the LZW worst case) by the plain decoder (host clock): "
          f"{ms_worst:.3f} ms on {smi}", flush=True)
    print("serve: one decode of each small image-kind sample by the plain decoder "
          "(host clock, ms): " + ", ".join(f"{n} {v:.3f}" for n, v in ms.items()
                                           if "720x1280" not in n) + f" on {smi}",
          flush=True)
    print(f"serve: the image-kind leg took {time.perf_counter() - t0:.1f} s", flush=True)


def phase_serve(model, smi: str) -> dict:
    """The serving daemon on the card: decode, the server end to end, and
    its load (utils/serve_bench.py). Returns the kernels' launches in the
    HTTP run."""
    import threading

    from vision_kit_tpu_torch.data import decode as dec
    from vision_kit_tpu_torch.ops.letterbox import letterbox_u8, scale_coords
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.serve import InferenceServer, _Request, decode_request_bytes
    from vision_kit_tpu_torch.utils import serve_bench as svb
    from vision_kit_tpu_torch.utils.stream_bench import same_detections

    t_phase = time.perf_counter()
    frames = serve_decode(smi)
    size = (640, 640)
    # every decoded sample, but one of each still-image kind of data/<kind>.py
    # other than WebP (serve_decode checked every such sample on its route)
    still = {k for k in dec.MODULE_KINDS if k != "webp"}
    names, payloads, seen = [], [], set()
    for name, meta, data in svb.samples():
        kind = meta["kind"].split("_")[0]
        if meta["shape"] is None or (kind in still and kind in seen):
            continue
        seen.add(kind)
        names.append(name)
        payloads.append(data)
    pred = Predictor(model, img_size=640, device="cuda")
    server = InferenceServer(pred, batch_size=SERVE_BATCH, max_wait_ms=5.0, port=0,
                             queue_size=4096)
    server.start()
    try:
        # the engine's result for each payload against Predictor.run on the
        # same device-decoded frame (slot 0 of a zero batch)
        want, lb = [], []
        for name in names:   # decode_request_bytes of each, from serve_decode's frame
            img, (ratio, pad) = letterbox_u8(frames[name], size)
            hw0 = tuple(frames[name].shape[:2])
            batch = torch.zeros((SERVE_BATCH, *size, 3), dtype=torch.uint8, device="cuda")
            batch[0] = img
            dets, valid = pred.run(batch)
            want.append(scale_coords(size, dets[0][valid[0]].cpu().numpy(), hw0,
                                     ratio_pad=(ratio, pad)))
            lb.append((img, ratio, pad, hw0))
        syncs = sync_points(lambda: pred.run(batch))
        print("serve: synchronising calls in one Predictor.run (torch sync debug "
              f"mode): {json.dumps(syncs) if syncs else 'none'}", flush=True)
        reqs = [_Request(*lb[i % len(lb)][:4], None) for i in range(64)]
        for r in reqs:
            server._queue.put(r)
        for i, r in enumerate(reqs):
            check(r.event.wait(120) and r.error is None, f"serve: engine request {i} "
                  f"failed: {r.error}")
            check(same_detections(want[i % len(want)], r.dets, 1e-5, 1e-3),
                  f"serve: engine result {i} differs from Predictor.run")
        check(sum(len(w) for w in want) > 0, "serve: no detections")
        print(f"serve: 64 engine requests over {len(payloads)} samples equal "
              "Predictor.run on the same device-decoded frames (class exact, score "
              "1e-5, box 1e-3 px)", flush=True)

        url = f"http://127.0.0.1:{server.port}"
        b0 = server._stats()["batches"]
        reset_counts()
        dec.decode_jpeg_cuda.calls = 0
        jp2_before = dec.route_counts["host_jp2"]
        n_posts = max(64, len(payloads))   # every payload posted at least once
        got = [None] * n_posts

        def client(k):
            for i in range(k, n_posts, 16):
                got[i] = post(url + "/predict", payloads[i % len(payloads)])

        threads = [threading.Thread(target=client, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in threads), "serve: a client hung")
        counts = read_counts()
        stats = server._stats()
        batches = stats["batches"] - b0
        for i, (code, body) in enumerate(got):
            check(code == 200, f"serve: POST {i} answered {code}: {body}")
            dets = np.array([d["box"] + [d["score"], d["class"]]
                             for d in body["detections"]], np.float32).reshape(-1, 6)
            check(same_detections(want[i % len(want)], dets, 2e-5, 1e-2),
                  f"serve: response {i} differs from Predictor.run beyond its rounding")
        n_jpeg = sum(1 for i in range(n_posts)
                     if dec.decode_route(payloads[i % len(payloads)], "cuda").startswith("nvjpeg"))
        check(counts["head_scores"] == counts["greedy_nms"] == batches > 0,
              f"serve: launches {counts} against {batches} batches")
        check(dec.decode_jpeg_cuda.calls == n_jpeg,
              f"serve: {dec.decode_jpeg_cuda.calls} nvJPEG decodes for {n_jpeg} JPEGs")
        kinds = sorted({m["kind"] for n, m, _ in svb.samples() if n in names})
        check({"jpeg_progressive", "bmp_24", "webp_lossy", "webp_animated"} <= set(kinds)
              and still <= {k.split("_")[0] for k in kinds}, f"serve: posted kinds {kinds}")
        print(f"serve: v5s@640 bf16 server, batch {SERVE_BATCH}, max_wait 5 ms: {n_posts} "
              f"POSTs from 16 clients of {len(payloads)} samples ({', '.join(kinds)}) "
              f"answered 200, each equal to Predictor.run within the JSON's rounding; "
              f"{batches} batches (avg {stats['avg_batch']}), launches {counts}, "
              f"{n_jpeg} nvJPEG decodes (the other kinds on the host)", flush=True)
        n_jp2 = dec.route_counts["host_jp2"] - jp2_before
        print(f"serve: host_jp2 took {n_jp2} bodies in the HTTP run (the server's decode "
              "workers, by the host C++ twin)", flush=True)
        check(n_jp2 > 0, "serve: no JPEG 2000 body on host_jp2")
        # one JP2 file (the HTTP run posted a raw J2K codestream) against the
        # same image posted as a PNG
        jp2_name, jp2_data = next((n, d) for n, m, d in svb.samples()
                                  if n.endswith(".jp2") and m["shape"] is not None)
        png = dec.encode_png(frames[jp2_name].cpu().numpy())
        code_a, body_a = post(url + "/predict", jp2_data)
        code_b, body_b = post(url + "/predict", png)
        check(code_a == code_b == 200, f"serve: the JP2 and PNG bodies answered {code_a}, "
              f"{code_b}")
        rows = [np.array([d["box"] + [d["score"], d["class"]] for d in b["detections"]],
                         np.float32).reshape(-1, 6) for b in (body_a, body_b)]
        check(len(rows[0]) > 0 and same_detections(rows[0], rows[1], 2e-5, 1e-2),
              "serve: the JP2 body's detections differ from the same image's as a PNG")
        print(f"serve: {jp2_name} and the same image as a PNG gave the same "
              f"{len(rows[0])} detections", flush=True)
        code, body = post(url + "/predict", b"this is not an image")
        check(code == 400, f"serve: garbage body answered {code}")
        code, body = post(url + "/predict", payloads[0])
        check(code == 200, "serve: no answer after a garbage body")
        print("serve: a garbage body gave 400 and the server still answers", flush=True)

        # -- load (utils/serve_bench.py) ---------------------------------
        sample_frames = [img for img, _, _, _ in lb]
        cap, p50, p99 = svb.bench_engine(server, 1600, frames=sample_frames)
        print(f"serve load: engine over {len(sample_frames)} decoded samples, batch "
              f"{SERVE_BATCH}: {cap:.1f} img/s, request p50 {p50:.3f} ms, p99 "
              f"{p99:.3f} ms on {smi}", flush=True)
        jpegs = svb.sample_bytes("jpeg_720p")
        ips, h50, h99 = svb.bench_http(server, 256, 32, payloads=jpegs)
        t_dec = svb.decode_ms(lambda d: decode_request_bytes(d, size, "cuda"),
                             jpegs, "cuda")
        t_nvjpeg = svb.decode_ms(lambda d: dec.decode_to(d, "cuda"), jpegs, "cuda")
        print(f"serve load: HTTP, 32 clients, 256 POSTs of the 720x1280 samples: "
              f"{ips:.1f} img/s, request p50 {h50:.3f} ms, p99 {h99:.3f} ms; one "
              f"request's decode alone (host clock, synchronised): nvJPEG + "
              f"orientation {t_nvjpeg:.3f} ms, + letterbox_u8 {t_dec:.3f} ms; the "
              f"engine's p50 {p50:.3f} ms on {smi}", flush=True)
        from vision_kit_tpu_torch.utils.path_turns import CONTENTION_S, http_contention

        heavy = svb.sample_bytes("webp_large")[0]
        alone = http_contention(server.port, CONTENTION_S, jpegs)
        beside = http_contention(server.port, CONTENTION_S, jpegs, heavy)
        check(beside["heavy_decodes"] > 0, "serve: the WebP client got no answer")
        print(f"serve load: HTTP, {CONTENTION_S:.0f} s of 32 clients POSTing the 720x1280 "
              f"samples: alone {alone['requests']} requests, {alone['img_s']:.1f} img/s, "
              f"p50 {alone['p50_ms']:.3f} ms, p99 {alone['p99_ms']:.3f} ms; beside one "
              f"more client POSTing the 2048x2048 lossy WebP ({len(heavy)} B) in a loop: "
              f"{beside['requests']} requests, {beside['img_s']:.1f} img/s, p50 "
              f"{beside['p50_ms']:.3f} ms, p99 {beside['p99_ms']:.3f} ms, p50 ratio "
              f"{beside['p50_ms'] / alone['p50_ms']:.3f}; the WebP client's "
              f"{beside['heavy_decodes']} decodes, median {beside['heavy_median_ms']:.1f} "
              f"ms; host-decode pool of {server._pool.size} processes on {smi}", flush=True)
        rows = svb.bench_load_curve(server, cap, (0.5, 0.8, 0.95), 480,
                                   frames=sample_frames)
        print("serve load: load curve at batch 8 against the engine's "
              f"{cap:.1f} img/s: " + "; ".join(
                  f"{f:.0%} offered {o:.1f} img/s, achieved {a:.1f}, p50 {q50:.3f} "
                  f"ms, p99 {q99:.3f} ms" for f, o, a, q50, q99 in rows)
              + f" on {smi}", flush=True)
    finally:
        server.stop()
    for batch in (8, 64):
        srv = InferenceServer(Predictor(model, img_size=640, device="cuda"),
                              batch_size=batch, max_wait_ms=2.0, port=0,
                              queue_size=8192, synthetic_ingest=4)
        srv.start()
        try:
            ips, p50, p99 = svb.bench_engine(srv, 200 * batch if batch == 8 else 6400)
        finally:
            srv.stop()
        print(f"serve load: engine with synthetic_ingest 4, batch {batch}: "
              f"{ips:.1f} img/s, request p50 {p50:.3f} ms, p99 {p99:.3f} ms on {smi}",
              flush=True)
    print(f"serve: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


FIT_BATCH, FIT_TRAIN, FIT_VAL, FIT_EPOCHS = 64, 128, 64, 2
FIT_HOST_BATCH = 8   # configs/yolov5.yaml's batch
FAST_SIZES, FAST_ITEMS = (640, 320, 160), 12   # fast_decode: f = 2, 4, 8 at 720x1280


def fit_config(data_dir: str, out: str, epochs: int = FIT_EPOCHS):
    """configs/yolov5_tpu.yaml (device augmentation, RAM cache, batch 64,
    val_interval 1) for v5s@640 bf16 with 2 classes on a write_dataset
    dataset, seeded weights, the loss gains scaled as the CLI scales them."""
    from vision_kit_tpu_torch.utils.config import load_config
    from vision_kit_tpu_torch.utils.general import update_loss_cfg

    cfg = load_config(os.path.join(REPO, "configs", "yolov5_tpu.yaml"))
    cfg.model.update(version="s", num_classes=2, input_size=[640, 640], weight="")
    cfg.data.update(data_dir=data_dir, output_dir=out, train_path="train",
                    val_path="valid", test_path="valid", batch_size=FIT_BATCH,
                    max_epochs=epochs, class_labels=["red", "green"])
    cfg.testing.val_interval = 1
    return update_loss_cfg(cfg)


@contextlib.contextmanager
def restored_determinism():
    """Put torch's deterministic algorithms and cuDNN's deterministic and
    benchmark flags back as they were (a Trainer(deterministic=True) sets
    them for the process)."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:]


class CrashingLoader:
    """A TrainLoader whose iterator raises after `after` batches."""

    def __init__(self, loader, after: int):
        self.loader, self.after = loader, after

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i == self.after:
                raise RuntimeError("crash injected by chip_smoke")
            yield batch


def state_distance(got: dict, want: dict, before: dict) -> dict:
    """|got - want| / |want - before| by part of two train_state_tensors
    layouts (the Euclidean norms over each part's tensors)."""
    out = {}
    for p in want:
        num = sum(float(((got[p][k] - w) ** 2).sum()) for k, w in want[p].items())
        den = sum(float(((w - before[p][k]) ** 2).sum()) for k, w in want[p].items())
        out[p] = (num / max(den, 1e-30)) ** 0.5
    return out


def deterministic_check(data_dir: str, out: str) -> dict:
    """`python3 chip_smoke.py --deterministic-check DATA OUT`, a child with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 set before CUDA starts: with
    Trainer(deterministic=True), an uninterrupted fit of fit_config, then a
    fit that crashes after step 3 (a loader that raises) resumed from its
    ckpts/last (an orbax directory); then a second uninterrupted
    deterministic fit, against the first; then the training step alone
    (run_train_bench, device aug) in both modes. Returns the step the crash
    saved and whether its ckpts/last was an orbax directory, the batch ids
    the resume trained on, both runs' final steps, the state tensors that
    differ from the first run's, the second fit's img/s by epoch and the
    step's img/s by mode."""
    from vision_kit_tpu_torch.train.trainer import Trainer
    from vision_kit_tpu_torch.utils import orbax
    from vision_kit_tpu_torch.utils import stream_bench as sb
    from vision_kit_tpu_torch.utils.general import deterministic_mode

    def trainer(name: str, deterministic: bool):
        return Trainer(fit_config(data_dir, os.path.join(out, name)), use_tensorboard=False,
                       seed=0, device="cuda", deterministic=deterministic)

    def differ(tr) -> list:
        got = sb.train_state_tensors(tr.state)
        return [f"{p} {k}" for p in sb.STATE_PARTS for k in want[p]
                if not torch.equal(want[p][k], got[p][k])]

    with restored_determinism():
        ref = trainer("ref", True)
        ref.fit()
        ref.train_loader.close()
        want = sb.train_state_tensors(ref.state)
        crashed = trainer("crash", True)
        crashed.train_loader = CrashingLoader(crashed.train_loader, 3)
        try:
            crashed.fit()
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        crashed.train_loader.close()
        last = os.path.join(crashed.output_dir, "ckpts", "last")
        with open(last + ".meta.json") as f:
            saved = json.load(f)["step"]
        last_is_orbax = orbax.is_checkpoint(last)
        del crashed
        resumed = trainer("crash", True)
        seen, orig = [], resumed.train_step

        def recording(state, batch):
            seen.append(resumed.train_loader._next_bid - 1)
            return orig(state, batch)

        resumed.train_step = recording
        resumed.fit(resume=last)
        resumed.train_loader.close()
    out_ = {"saved_step": saved, "last_is_orbax": last_is_orbax, "seen": seen,
            "step": resumed.state.step,
            "ref_step": ref.state.step, "resume_differ": differ(resumed)[:5]}
    del resumed
    torch.cuda.empty_cache()

    with restored_determinism():
        tr = trainer("again", True)
        tr.fit()
        torch.cuda.synchronize()
    tr.train_loader.close()
    img_s, again = [e["img_s"] for e in tr.epoch_stats], differ(tr)[:5]
    del tr
    torch.cuda.empty_cache()

    step_img_s = {}
    for mode in ("default", "deterministic"):
        with restored_determinism():
            if mode == "deterministic":
                deterministic_mode()
            rec = sb.run_train_bench(ref.model, ref.loss, batch=FIT_BATCH, iters=10,
                                     warmup=3, device_aug=True)
        step_img_s[mode] = rec["value"]
    return {**out_, "again_differ": again, "img_s": img_s, "step_img_s": step_img_s}


def fast_decode_leg(data_dir: str, smi: str) -> None:
    """data.fast_decode on write_dataset's files: the plain decoder on the
    host, reduced in the DCT where the ratio allows. YOLODataset(fast_decode=
    True)'s items on the card against the CPU's at FAST_SIZES, and each
    decode route's ms for a 720x1280 sample (f = 2, 4, 8)."""
    from vision_kit_tpu_torch.utils import video_bench as vb
    from vision_kit_tpu_torch.utils.serve_bench import sample_bytes

    t0 = time.perf_counter()
    bad, reduced, files = vb.fast_decode_disagreements(
        os.path.join(data_dir, "train"), FAST_SIZES, range(FAST_ITEMS))
    check(bad == [], f"fast_decode: the card's items differ from the CPU's: {bad[:5]}")
    check(all(reduced[size] > 0 for size in FAST_SIZES),
          f"fast_decode: items that took the reduced decode {reduced}")
    progressive = [f for f in files if "progressive" in f]
    check(any("progressive_720x1280" in f for f in progressive),
          f"fast_decode: no progressive file reduced: {files}")
    check_s = time.perf_counter() - t0
    frame = sample_bytes("jpeg_720p")[0]
    route_ms = {size: vb.decode_route_ms(frame, size, "cuda", reps=2) for size in FAST_SIZES}
    print(f"fit: YOLODataset(fast_decode=True) over the fit's train split at "
          f"{', '.join(map(str, FAST_SIZES))}: items 0-{FAST_ITEMS - 1} and the "
          f"progressive files on the card bit-equal to the CPU's (image, labels, (h0, "
          f"w0)), of which {', '.join(str(reduced[s]) for s in FAST_SIZES)} took the "
          f"reduced decode, the progressive ones {progressive} "
          f"({check_s:.1f} s); a 720x1280 sample, median ms an image (host clock, "
          f"synchronised) reduced plain / full plain / nvJPEG + resize_u8: "
          + "; ".join(f"{size} (f = {1280 // size}) {r['reduced']:.3f} / "
                      f"{r['full']:.3f} / {r['nvjpeg']:.3f}"
                      for size, r in route_ms.items())
          + f"; the leg {time.perf_counter() - t0:.1f} s on {smi}", flush=True)


def restore_leg(restored: dict) -> dict:
    """The ms (host clock) of datasets.restore_truncated_jpeg on each of the
    fit's truncated samples alone, each checked against its manifest's
    restored_sha256."""
    import hashlib

    from vision_kit_tpu_torch.data.datasets import restore_truncated_jpeg
    from vision_kit_tpu_torch.utils import serve_bench as svb

    by_name = {n: d for n, _, d in svb.samples()}
    out = {}
    for name, sha in restored.items():
        t0 = time.perf_counter()
        data = restore_truncated_jpeg(by_name[name])
        out[name] = (time.perf_counter() - t0) * 1e3
        check(hashlib.sha256(data).hexdigest() == sha, f"fit: {name} restores otherwise")
    return out


def run_directory_checks(tr, run: str) -> list:
    """The run directory of a finished fit as the JAX Trainer writes it:
    ckpts/last and ckpts/best orbax directories with their metas, last
    read on the card equal to the state's JAX tree bit for bit; the best
    weights a .msgpack; train.jpg and val.jpg JPEGs that decode. Returns
    the Trainer's background saves ({"path", "blocked_s", "write_s",
    "mb"})."""
    import glob

    from vision_kit_tpu_torch import convert
    from vision_kit_tpu_torch.data.decode import decode_image
    from vision_kit_tpu_torch.utils import orbax

    for name in ("last", "best"):
        path = os.path.join(run, "ckpts", name)
        check(orbax.is_checkpoint(path) and os.path.isfile(path + ".meta.json"),
              f"fit wrote no orbax directory ckpts/{name} with its meta")
    check(not glob.glob(os.path.join(run, "**", "*.pt"), recursive=True)
          and not glob.glob(os.path.join(run, "*.png")), "fit wrote a .pt or a .png")
    want = flat_leaves(convert.jax_train_state_tree(tr.state))
    got = flat_leaves(orbax.read_checkpoint(os.path.join(run, "ckpts", "last"), device="cuda"))
    check(sorted(got) == sorted(want) and all(leaf_data(got[k]) == leaf_data(w)
                                              for k, w in want.items()),
          "ckpts/last read on the card differs from the state's JAX tree")
    check(len(glob.glob(os.path.join(run, "weights", "best-map50_*.msgpack"))) > 0,
          "fit exported no best weights")
    for name in ("train.jpg", "val.jpg"):
        with open(os.path.join(run, name), "rb") as f:
            data = f.read()
        img = decode_image(data)
        check(data[:2] == b"\xff\xd8" and img is not None and img.ndim == 3,
              f"{name} is not a JPEG that decodes")
    mb = sum(len(leaf_data(w)[2]) for w in want.values()) / 1e6
    saves = [dict(r, mb=mb) for r in tr.checkpointer.records]
    check(len(saves) >= 2 and all(r["write_s"] is not None for r in saves),
          f"the Trainer's background saves: {saves}")
    return saves


def phase_fit(smi: str) -> dict:
    """Training from a dataset: Trainer.fit of v5s@640 bf16 for 2 epochs on
    write_dataset's files (the committed samples by their decode routes,
    progressive JPEGs and BMPs kept, PNG scenes, the truncated samples
    restored by the scan to the bytes JAX writes), then test(); the card's loaders against
    the plain ones; fast_decode_leg; a crash after step 3 resumed on the
    card; the train CLI as a subprocess; the loader's numbers. Returns the
    greedy_nms and head_scores launches of fit."""
    import glob
    import subprocess
    import tempfile

    from vision_kit_tpu_torch import convert
    from vision_kit_tpu_torch.data.datasets import YOLODataset
    from vision_kit_tpu_torch.predictor import load_predictor_from_config
    from vision_kit_tpu_torch.train.trainer import Trainer
    from vision_kit_tpu_torch.utils import loader_bench as lb
    from vision_kit_tpu_torch.utils import orbax
    from vision_kit_tpu_torch.utils import stream_bench as sb
    from vision_kit_tpu_torch.utils.config import save_config

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "ds")
        made = lb.write_dataset(data_dir, FIT_TRAIN, FIT_VAL)
        restore_ms = restore_leg(made["restored"])
        cfg = fit_config(data_dir, os.path.join(tmp, "run"))
        tr = Trainer(cfg, use_tensorboard=False, seed=0, device="cuda")
        n_restored = len(made["restored"])
        kept = tr.train_loader.planner.dataset.img_files
        check(len(kept) == FIT_TRAIN + n_restored and n_restored >= 2
              and all(os.path.join(data_dir, "train", "images", n) in kept
                      for n in made["restored"]),
              f"the scan kept {len(kept)} of {FIT_TRAIN} + {n_restored} truncated images")
        bad = lb.restore_disagreements(data_dir, made["restored"])
        check(not bad, "fit: restores differ from JAX's: " + "; ".join(bad))
        check(tr.train_loader.device.type == "cuda", "the train dataset is not on the card")
        kept_webp = [f for f in tr.train_loader.planner.dataset.img_files if f.endswith(".webp")]
        check(len(kept_webp) > 0, "the scan kept no WebP of the fit's dataset")
        before = sb.train_state_tensors(tr.state)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        tr.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts()
        n_val = FIT_EPOCHS * len(tr.val_loader)
        check(counts == {"greedy_nms": n_val, "head_scores": 0},
              f"fit launched {counts}, not one greedy_nms per validation batch ({n_val})")
        check(tr.global_step == tr.state.step == FIT_EPOCHS * FIT_TRAIN // FIT_BATCH,
              f"fit ended at step {tr.global_step}")
        run = cfg.data.output_dir
        saves = run_directory_checks(tr, run)
        best = sorted(glob.glob(os.path.join(run, "weights", "best-map50_*.msgpack")))
        reset_counts()
        result = tr.test()
        test_counts = read_counts()
        check(test_counts["greedy_nms"] == len(tr.val_loader),
              f"test() launched {test_counts}")
        check(all(np.isfinite(result[k]) for k in ("map50", "map50_95")),
              f"test() mAP {result['map50']}, {result['map50_95']}")
        # the best weights, a Flax msgpack: the f32 EMA that ckpts/best holds
        pred = load_predictor_from_config(cfg, weights=best[-1], device="cuda")
        ema = convert.state_dict_from_jax_variables(
            orbax.read_checkpoint(os.path.join(run, "ckpts", "best"), device="cuda")["ema"]["tree"])
        served = pred.model.state_dict()
        check(all(torch.equal(served[k].cpu(), v) and served[k].dtype == torch.float32
                  for k, v in ema.items() if not k.endswith("num_batches_tracked")),
              "the best weights served are not ckpts/best's f32 EMA")
        frames = next(iter(tr.val_loader))["image"][:4].cpu().numpy()
        reset_counts()
        dets, _ = pred.predict_batch(frames)
        serve_counts = read_counts()
        check(serve_counts["greedy_nms"] > 0 and serve_counts["head_scores"] > 0,
              f"serving the best weights launched {serve_counts}")
        check(all(np.isfinite(d).all() for d in dets), "best weights: non-finite detections")
        stats = tr.epoch_stats
        print(f"fit: v5s@640 b{FIT_BATCH} bf16 (2 classes), {FIT_EPOCHS} epochs of "
              f"{tr.steps_per_epoch} steps on {len(kept)} train images ({len(kept_webp)} "
              f"WebPs kept by the scan, {n_restored} truncated ones restored by it to "
              f"their manifest's restored_sha256, ms a restore alone "
              + ", ".join(f"{v:.1f}" for v in restore_ms.values())
              + "), RAM cache on the card, device aug with "
              f"mosaic: fit {fit_s:.1f} s; per epoch "
              + "; ".join(f"{e['img_s']:.1f} img/s ({e['seconds']:.2f} s, loader wait "
                          f"{100 * e['loader_wait_s'] / e['seconds']:.1f} %), validation "
                          f"{e['val_s']:.2f} s" for e in stats)
              + f"; launches {counts}; test() mAP@.5 {result['map50']:.4f} launches "
              f"{test_counts}; {os.path.basename(best[-1])} (ckpts/best's f32 EMA) served "
              f"by load_predictor_from_config, launches {serve_counts} on {smi}",
              flush=True)
        print(f"fit: ckpts/last and ckpts/best orbax directories, last read on the card "
              f"equal to the state's JAX tree bit for bit; train.jpg and val.jpg decode; "
              f"{len(saves)} saves of the {saves[0]['mb']:.1f} MB state in the background "
              f"(AsyncCheckpointer), the Trainer blocked (the snapshot) "
              + ", ".join(f"{r['blocked_s'] * 1e3:.1f}" for r in saves)
              + " ms, the writer " + ", ".join(f"{r['write_s'] * 1e3:.1f}" for r in saves)
              + f" ms (host clock) on {smi}", flush=True)

        # the card's loaders against the plain ones, over the same files
        card_ds = tr.train_loader.planner.dataset
        plain_ds = YOLODataset(os.path.join(data_dir, "train"), img_size=640, device="cpu",
                               cache_images="ram")
        bad = lb.loader_disagreements(card_ds, plain_ds, batch=16, size=640, n_batches=2,
                                      aug={"enable_mixup": True, "mixup_prob": 1.0})
        check(bad == [], f"card loaders disagree with the plain ones: {bad[:5]}")
        print("fit: card loaders vs plain (2 TrainLoader batches of 16 with mixup, 2 "
              "ValLoader batches of 16): params, tile_hw, targets and infos equal, PNG "
              "pixels bit-equal, JPEG pixels within decode.NVJPEG_TOLERANCE", flush=True)
        del plain_ds

        # a second uninterrupted run from the same seed, in the default
        # (non-deterministic) mode: how far apart two runs land
        twin = Trainer(fit_config(data_dir, os.path.join(tmp, "twin")),
                       use_tensorboard=False, seed=0, device="cuda")
        twin.fit()
        twin_dist = state_distance(sb.train_state_tensors(twin.state),
                                   sb.train_state_tensors(tr.state), before)
        print("fit: a twin run from the same seed, default mode: |twin - run| / |run's "
              "change| by part " + json.dumps({k: round(v, 6) for k, v in twin_dist.items()}),
              flush=True)
        del twin

        # decoder "plain": the same batch bytes with 0 and 8 workers
        t0 = time.perf_counter()
        plain_card = YOLODataset(os.path.join(data_dir, "train"), img_size=640,
                                 device="cuda", decoder="plain")
        aug = dict(fit_host_config(data_dir, tmp).augmentations)
        bad = lb.workers_disagreements(plain_card, FIT_HOST_BATCH, 640, workers=8, aug=aug)
        check(bad == [], f"decoder 'plain': 0 and 8 workers give other batches: {bad[:5]}")
        print(f"fit: decoder 'plain' on the card, the host route of configs/yolov5.yaml "
              f"(degrees 5, shear 2): 2 TrainLoader batches of {FIT_HOST_BATCH} with 0 "
              f"workers (every op on the card) and with 8 (on the host) bit-equal, images "
              f"and targets; {time.perf_counter() - t0:.1f} s", flush=True)
        del plain_card

        fast_decode_leg(data_dir, smi)

        # in a child process (CUBLAS_WORKSPACE_CONFIG set before CUDA
        # starts): two Trainer(deterministic=True) fits against each other, a
        # crash after step 3 resumed from ckpts/last, and the step in both modes
        t0 = time.perf_counter()
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                            "--deterministic-check", data_dir,
                            os.path.join(tmp, "deterministic")],
                           cwd=REPO, env=env, capture_output=True, text=True, timeout=400)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("DETERMINISTIC ")]
        check(r.returncode == 0 and lines,
              f"the deterministic check exited {r.returncode}: {r.stderr[-2000:]}")
        res = json.loads(lines[-1][len("DETERMINISTIC "):])
        check(res["again_differ"] == [],
              f"the second deterministic fit differs from the first: {res['again_differ']}")
        step = res["step_img_s"]
        print(f"fit: Trainer(deterministic=True) in a child process: a second "
              f"uninterrupted fit bit-identical to the first ("
              + ", ".join(f"{v:.1f}" for v in res["img_s"]) + " img/s by epoch); the step "
              f"alone (run_train_bench, device aug, b{FIT_BATCH}): default "
              f"{step['default']:.1f}, deterministic {step['deterministic']:.1f} img/s "
              f"({100 * (step['deterministic'] / step['default'] - 1):+.1f} %); the child "
              f"{time.perf_counter() - t0:.1f} s on {smi}", flush=True)
        want_steps = FIT_EPOCHS * FIT_TRAIN // FIT_BATCH
        check(res["saved_step"] == 3, f"the crash saved step {res['saved_step']}, not 3")
        check(res["last_is_orbax"], "the crash saved no orbax directory as ckpts/last")
        check(res["seen"] == list(range(3, want_steps)), f"the resume saw batches {res['seen']}")
        check(res["step"] == res["ref_step"] == want_steps,
              f"the resume ended at step {res['step']}, the run at {res['ref_step']}")
        check(not res["resume_differ"],
              f"the resumed state differs from the run's: {res['resume_differ']}")
        print(f"fit: Trainer(deterministic=True) in a child process: a crash after step 3 "
              f"saved step {res['saved_step']} as the orbax directory ckpts/last; the "
              f"resume from it saw batches {res['seen']} and "
              f"ended at step {res['step']}, every state tensor bit-identical to an "
              f"uninterrupted run's", flush=True)

        # the CLI, as a user runs it
        cli_cfg = fit_config(data_dir, os.path.join(tmp, "cli"), epochs=1)
        save_config(cli_cfg, os.path.join(tmp, "cli.yaml"))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "vision_kit_tpu_torch", "train", "-c",
                            os.path.join(tmp, "cli.yaml")], cwd=REPO, capture_output=True,
                           text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        logs = glob.glob(os.path.join(tmp, "cli", "YOLOv5", "train", "*", "log.log"))
        check(r.returncode == 0, f"train CLI exited {r.returncode}: {r.stderr[-2000:]}")
        check(len(logs) == 1 and "mAP@.5" in open(logs[0]).read(),
              "the train CLI logged no mAP@.5")
        print(f"fit: python -m vision_kit_tpu_torch train -c <cfg> (1 epoch): exit 0 in "
              f"{cli_s:.1f} s, mAP@.5 logged", flush=True)

        # where an epoch's wall goes: one more epoch at a time through
        # fit(resume=last) (a warm-up epoch, then one under the profiler),
        # and the sample grid alone
        def one_more_epoch():
            tr.max_epochs += 1
            tr.fit(resume=os.path.join(run, "ckpts", "last"))

        prof = profile_device(one_more_epoch, 1, TRAIN_PROFILE_GROUPS, TRAIN_RANGES)
        batch = next(iter(tr.train_loader))
        tr.train_loader.close()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr._save_grid(batch, "probe")
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        print(f"fit: one epoch (2 steps, the validation, a checkpoint; resumed from "
              f"ckpts/last) under the profiler, device ms by kernel group and range: "
              f"{json.dumps(prof)}; the sample grid alone (warp of 16 tiles, JPEG) "
              f"{grid_s:.3f} s on {smi}", flush=True)
        del batch

        # the loader alone, and the step alone on the fit's model
        uncached = YOLODataset(os.path.join(data_dir, "train"), img_size=640, device="cuda")
        rates = {"uncached (nvJPEG)": lb.train_loader_rate(uncached, FIT_BATCH, 640, 1),
                 "RAM cache": lb.train_loader_rate(card_ds, FIT_BATCH, 640, 2)}
        val_img_s = lb.val_loader_rate(
            YOLODataset(os.path.join(data_dir, "valid"), img_size=640, device="cuda"),
            FIT_BATCH, 640)
        step_alone = sb.run_train_bench(tr.model, tr.loss, batch=FIT_BATCH, iters=10,
                                        warmup=3, device_aug=True)
        print("fit: loader at b64@640 on the card: "
              + "; ".join(f"{n} {r['img_s']:.1f} img/s with its prefetch thread, "
                          f"{r['batch_ms']:.1f} ms a batch alone" for n, r in rates.items())
              + f"; ValLoader uncached {val_img_s:.1f} img/s; run_train_bench of the fit's "
              f"model (device aug) {step_alone['value']:.1f} img/s beside fit's "
              + ", ".join(f"{e['img_s']:.1f}" for e in stats) + f" img/s on {smi}",
              flush=True)
    del tr, pred
    torch.cuda.empty_cache()
    print(f"fit: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


FIT_HOST_EPOCHS = 2


def fit_host_config(data_dir: str, out: str):
    """configs/yolov5.yaml as it stands (v5s@640, batch 8, 8 workers, no
    image cache, the host-augmentation route) but for data_dir and
    output_dir, 2 classes and their labels, FIT_HOST_EPOCHS epochs, and
    degrees 5 and shear 2 (the rotation/shear warp); the loss gains scaled
    as the CLI scales them."""
    from vision_kit_tpu_torch.utils.config import load_config
    from vision_kit_tpu_torch.utils.general import update_loss_cfg

    cfg = load_config(os.path.join(REPO, "configs", "yolov5.yaml"))
    cfg.model.update(num_classes=2)
    cfg.data.update(data_dir=data_dir, output_dir=out, max_epochs=FIT_HOST_EPOCHS,
                    class_labels=["red", "green"])
    cfg.augmentations.update(degrees=5.0, shear=2.0)
    return update_loss_cfg(cfg)


def phase_fit_host(smi: str) -> dict:
    """Training on the repo's default config (fit_host_config) through the
    host-augmentation route, then test(); the route's ops and loader
    batches on the card against the CPU (the route's loader rates alone are
    utils/loader_bench.py:host_route_rates, run apart). Returns the
    greedy_nms and head_scores launches of fit."""
    import tempfile

    from vision_kit_tpu_torch.data.datasets import YOLODataset
    from vision_kit_tpu_torch.train.trainer import Trainer
    from vision_kit_tpu_torch.utils import loader_bench as lb
    from vision_kit_tpu_torch.utils import orbax

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "ds")
        made = lb.write_dataset(data_dir, FIT_TRAIN, FIT_VAL)
        cfg = fit_host_config(data_dir, os.path.join(tmp, "run"))
        batch, workers = int(cfg.data.batch_size), int(cfg.data.num_workers)
        check((batch, workers, cfg.model.version, getattr(cfg.data, "device_aug", None),
               getattr(cfg.data, "cache_images", None)) == (8, 8, "s", None, None),
              "configs/yolov5.yaml is not batch 8, 8 workers, v5s, host route, uncached")
        tr = Trainer(cfg, use_tensorboard=False, seed=0, device="cuda")
        loader = tr.train_loader
        check(not tr.device_aug and not loader.device_aug, "fit-host took the device route")
        check(loader.device.type == "cuda"
              and len(loader.dataset) == FIT_TRAIN + len(made["restored"]),
              f"the train dataset holds {len(loader.dataset)} images on {loader.device}")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        tr.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts()
        n_val = len(tr.val_loader)
        check(counts == {"greedy_nms": FIT_HOST_EPOCHS * n_val, "head_scores": 0},
              f"fit launched {counts}, not one greedy_nms per validation batch "
              f"({FIT_HOST_EPOCHS} x {n_val})")
        check(tr.global_step == tr.state.step == FIT_HOST_EPOCHS * FIT_TRAIN // batch,
              f"fit ended at step {tr.global_step}")
        check(all(bool(torch.isfinite(v).all()) for v in tr.state.params.values()),
              "fit left non-finite parameters")
        check(orbax.is_checkpoint(os.path.join(cfg.data.output_dir, "ckpts", "last")),
              "fit wrote no orbax directory ckpts/last")
        reset_counts()
        result = tr.test()
        test_counts = read_counts()
        check(test_counts == {"greedy_nms": n_val, "head_scores": 0},
              f"test() launched {test_counts}")
        check(all(np.isfinite(result[k]) for k in ("map50", "map50_95")),
              f"test() mAP {result['map50']}, {result['map50_95']}")
        stats = tr.epoch_stats
        print(f"fit-host: configs/yolov5.yaml (v5s@640 bf16, batch {batch}, {workers} "
              f"spawned workers, uncached, host augmentation with degrees 5 and shear 2), "
              f"2 classes, {FIT_HOST_EPOCHS} epochs of {tr.steps_per_epoch} steps on "
              f"{FIT_TRAIN} train images: fit {fit_s:.1f} s; per epoch "
              + "; ".join(f"{e['img_s']:.1f} img/s ({e['seconds']:.2f} s, loader wait "
                          f"{100 * e['loader_wait_s'] / e['seconds']:.1f} %), validation "
                          f"{e['val_s']:.2f} s" for e in stats)
              + f"; launches {counts} ({counts['greedy_nms'] / (FIT_HOST_EPOCHS * n_val):.0f}"
              f" greedy_nms per validation batch of {batch}); test() mAP@.5 "
              f"{result['map50']:.4f} launches {test_counts} on {smi}", flush=True)
        del tr

        # the route's ops, and its loader batches, on the card against the CPU
        t0 = time.perf_counter()
        bad = lb.imgproc_disagreements("cuda")
        check(bad == [], f"host-route ops on the card differ from the CPU: {bad[:5]}")
        ops_s = time.perf_counter() - t0
        png_dir = os.path.join(tmp, "png")
        lb.write_dataset(png_dir, 16, 8, png_only=True)
        split = os.path.join(png_dir, "train", "images")
        card_ds = YOLODataset(split, img_size=640, device="cuda")
        plain_ds = YOLODataset(split, img_size=640, device="cpu")
        check(card_ds.device.type == "cuda", "the PNG dataset is not on the card")
        bad = lb.host_loader_disagreements(card_ds, plain_ds, batch=batch, size=640,
                                           aug=dict(lb.HOST_AUG, enable_mixup=True))
        check(bad == [], f"host-route batches on the card differ from the CPU: {bad[:5]}")
        print(f"fit-host: card vs CPU, bit for bit: every ops/imgproc.py op at 640 and "
              f"1280 (warp under rotation/shear/translation x3, HSV x3, blur and median "
              f"3/5/7, gray, Lab, CLAHE, Lab back, pad; {ops_s:.1f} s), and 2 host-route "
              f"TrainLoader batches of {batch} with mixup, degrees and shear from PNG "
              f"scenes on the card (num_workers 0) against the CPU: images and targets "
              f"equal", flush=True)
        del card_ds, plain_ds
    torch.cuda.empty_cache()
    print(f"fit-host: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


DDP_BATCH = 64   # the global batch of the ddp phase's steps (v5s@640)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_step_failures(res: dict) -> list:
    """What fails in a data-parallel step's check (stream_bench.
    mesh_step_disagreements with its float64 referee, cuDNN on, in
    deterministic mode):

    - the float64 step under the mesh must equal the float64 step without
      it at test_torch_train.py's tolerances (1e-4 of a tensor plus 2e-3 of
      its change, losses 1e-4): the data-parallel arithmetic itself;
    - the f32 step under the mesh must lie no further from the float64 step
      than the f32 step without a mesh, on the rows of its worst rank
      alone, lies from its own float64 step. cuDNN's f32 convolutions
      round by the rows they are given: of the ddp phase's batch, on an
      H100, rows 32-63 alone lie 56.7x the tolerance from float64, rows
      0-31 alone 6.0x, the 64 together 3.2x; so a rank's f32 step is held
      to what its own rows cost without a mesh. At a world of 1 that is the step
      without a mesh on the whole batch."""
    m = res["metrics"]
    out = []
    if m["f64_disagreements"]:
        out.append(f"in float64 the mesh step differs from the step without it in "
                   f"{len(m['f64_disagreements'])} tensors or metrics: "
                   f"{m['f64_disagreements'][:3]}")
    bound = max(m["alone_vs_f64"])
    if not m["mesh_vs_f64"] <= bound:
        out.append(f"the f32 mesh step lies {m['mesh_vs_f64']:.3f}x the tolerance from the "
                   f"float64 step, beyond the {bound:.3f}x of its ranks' rows alone")
    return out


def ddp_world1(port: int) -> dict:
    """`python3 chip_smoke.py --ddp-world1 PORT` (deterministic mode): a
    world of 1 over NCCL through init_distributed; a v5s@640 step of b64
    under the mesh against the same step without it, in f32 and float64
    (stream_bench.mesh_step_disagreements); then the bf16 training step
    (run_train_bench, b64) with and without the mesh, once each."""
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.parallel import init_distributed, make_mesh
    from vision_kit_tpu_torch.train.losses import YoloLoss
    from vision_kit_tpu_torch.utils import stream_bench as sb

    sb.deterministic()
    check(init_distributed(f"127.0.0.1:{port}", 1, 0), "init_distributed did not join")
    try:
        check(torch.distributed.get_backend() == "nccl",
              f"backend {torch.distributed.get_backend()}, not nccl")
        mesh = make_mesh()
        bad, metrics = sb.mesh_step_disagreements(mesh, v5s_config(), batch=DDP_BATCH,
                                                  referee=True)
        model = build_model(v5s_config(), device=mesh.device, dtype=torch.bfloat16, seed=0)
        loss = YoloLoss(80, model.head.grid_anchors, sb.TRAIN_HYP, layout="native")
        rates = {"mesh": [], "plain": []}
        for name in ("mesh", "plain"):
            rec = sb.run_train_bench(model, loss, DDP_BATCH, iters=10, warmup=3,
                                     mesh=mesh if name == "mesh" else None)
            rates[name].append(rec["value"])
        return {"disagreements": [list(map(str, b)) for b in bad[:5]],
                "n_disagreements": len(bad), "metrics": metrics, "img_s": rates,
                "backend": torch.distributed.get_backend()}
    finally:
        torch.distributed.destroy_process_group()


def ddp_rank(rank: int, port: int, data_dir: str, out: str) -> dict:
    """`python3 chip_smoke.py --ddp-rank RANK PORT DATA OUT`, one of two
    processes sharing the card over gloo with CUDA tensors (deterministic
    mode): the v5s@640 step of 2x32 against the 1x64 step in f32 and
    float64, and each rank's rows alone (mesh_step_disagreements); the bf16
    step at 32 a rank
    (run_train_bench); Trainer.fit (fit_config: v5s@640 bf16, global batch
    64, 2 epochs) with each rank's greedy_nms launches; the validation on
    both ranks against rank 0 alone over the whole batches, detections and
    metrics. Returns this rank's numbers and the digest of its state."""
    import hashlib

    from vision_kit_tpu_torch.data.loader import ValLoader
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.parallel import init_distributed, make_mesh
    from vision_kit_tpu_torch.parallel.mesh import barrier
    from vision_kit_tpu_torch.train import trainer as trainer_mod
    from vision_kit_tpu_torch.train.evaluator import DetEvaluator
    from vision_kit_tpu_torch.train.losses import YoloLoss
    from vision_kit_tpu_torch.train.step import make_eval_step
    from vision_kit_tpu_torch.utils import orbax
    from vision_kit_tpu_torch.utils import stream_bench as sb

    sb.deterministic()
    check(init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo"),
          "init_distributed did not join")
    try:
        mesh = make_mesh()
        check(mesh.device == torch.device("cuda", 0), f"rank {rank} on {mesh.device}")
        bad, metrics = sb.mesh_step_disagreements(mesh, v5s_config(), batch=DDP_BATCH,
                                                  referee=True)
        res = {"rank": rank, "metrics": metrics}
        torch.cuda.empty_cache()
        if rank == 0:
            res["disagreements"] = [list(map(str, b)) for b in bad[:5]]
            res["n_disagreements"] = len(bad)

        model = build_model(v5s_config(), device=mesh.device, dtype=torch.bfloat16, seed=0)
        loss = YoloLoss(80, model.head.grid_anchors, sb.TRAIN_HYP, layout="native")
        rec = sb.run_train_bench(model, loss, DDP_BATCH // 2, iters=5, warmup=2, mesh=mesh)
        res["step_ms"], res["step_img_s"] = rec["step_ms"], DDP_BATCH * 1000 / rec["step_ms"]
        del model

        cfg = fit_config(data_dir, out)
        tr = trainer_mod.Trainer(cfg, use_tensorboard=False, seed=0, device="cuda",
                                 mesh=mesh)
        reset_counts()
        t0 = time.perf_counter()
        tr.fit()
        torch.cuda.synchronize()
        res["fit_s"] = time.perf_counter() - t0
        res["launches"] = read_counts()
        # rank 0 wrote it; every rank is past the barrier of fit's last wait
        res["last_is_orbax"] = orbax.is_checkpoint(os.path.join(out, "ckpts", "last"))
        res["saves"] = len(tr.checkpointer.records)
        res["n_val_batches"] = len(tr.val_loader)
        res["epochs"] = [{k: e[k] for k in ("img_s", "seconds", "loader_wait_s", "val_s")}
                         for e in tr.epoch_stats]
        res["step"] = tr.global_step
        h = hashlib.sha256()
        tensors = sb.train_state_tensors(tr.state)
        for part in sb.STATE_PARTS:
            for k in sorted(tensors[part]):
                h.update(tensors[part][k].numpy().tobytes())
        res["digest"] = h.hexdigest()

        # the validation on both ranks, then on rank 0 alone over whole batches
        dets = {}

        def recording(step, name):
            def run(imgs):
                d, v = step(imgs)
                dets.setdefault(name, []).append((d.cpu(), v.cpu()))
                return d, v
            return run

        tr.eval_step = recording(tr.eval_step, "mesh")
        both = tr.validate()
        if rank == 0:
            one_step = make_eval_step(
                tr.model, state=tr.state, compute_dtype=tr.compute_dtype,
                postprocess_kwargs=dict(conf_thres=float(cfg.testing.conf_thresh),
                                        iou_thres=float(cfg.testing.iou_thresh)))
            alone = trainer_mod.validate(
                recording(one_step, "one"),
                ValLoader(tr.val_loader.dataset, tr.batch_size, img_size=tr.img_size),
                DetEvaluator(list(cfg.data.class_labels), tr.img_size))
            pairs = [(g[0][i][g[1][i]].numpy(), w[0][i][w[1][i]].numpy())
                     for g, w in zip(dets["mesh"], dets["one"]) for i in range(len(w[0]))]
            res["validate"] = {
                "n_batches": [len(dets["mesh"]), len(dets["one"])],
                "same_detections": all(sb.same_detections(w, g, 1e-5, 1e-3)
                                       for g, w in pairs),
                "bit_equal": all(np.array_equal(g, w) for g, w in pairs),
                "n_detections": int(sum(v.sum() for _, v in dets["one"])),
                "mesh": {k: both[k] for k in ("map50", "map50_95")},
                "one": {k: alone[k] for k in ("map50", "map50_95")},
                "max_diff": max([abs(both[k] - alone[k]) for k in ("map50", "map50_95")]
                                + [abs(g[k] - w[k]) for g, w in zip(both["per_class"],
                                                                     alone["per_class"])
                                   for k in ("precision", "recall", "ap50", "ap")])}
        barrier(mesh)
        tr.train_loader.close()
        del tr
        torch.cuda.empty_cache()
        res["serve"] = mesh_serving(mesh)
        return res
    finally:
        torch.distributed.destroy_process_group()


MESH_FRAMES = 8   # a mesh serving request: 8 frames of 720x1280, 4 a rank


def matching_detections(want: np.ndarray, got: np.ndarray, score_tol: float,
                        box_tol: float) -> int:
    """How many rows of `got` match a distinct row of `want`: the class
    exact, the score within score_tol, every coordinate within box_tol px."""
    free = np.ones(len(want), bool)
    n = 0
    for row in got:
        ok = (free & (want[:, 5] == row[5]) & (np.abs(want[:, 4] - row[4]) <= score_tol)
              & (np.abs(want[:, :4] - row[:4]).max(axis=1) <= box_tol))
        if ok.any():
            free[np.argmax(ok)] = False
            n += 1
    return n


def mesh_serving(mesh) -> dict:
    """On each of the ddp phase's ranks: the main path's v5s@640 bf16
    (calibrated head) behind Predictor(mesh=mesh). predict_batch on 8
    frames of 720x1280 (4 a rank) and on 3 (they do not divide: every rank
    runs all 3), each rank's detections against the same Predictor without
    a mesh on the rows it ran, and rank 0's against one process at b8; the
    request latency and each kernel's launches; then InferenceServer over
    the mesh Predictor (rank 0 binds HTTP, rank 1 follows) answering each
    committed sample JPEG one at a time, rank 0's answers against a
    one-process server at batch 4 on the same card (the rows rank 0 ran)."""
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.parallel.mesh import shard_rows
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.serve import InferenceServer
    from vision_kit_tpu_torch.utils import serve_bench as svb
    from vision_kit_tpu_torch.utils.stream_bench import calibrate_head, same_detections

    t0 = time.perf_counter()
    model = build_model(v5s_config(), device=mesh.device, dtype=torch.bfloat16, seed=0)
    calibrate_head(model, 640, seed=1)
    pred = Predictor(model, img_size=640, mesh=mesh)
    alone = Predictor(model, img_size=640, device=mesh.device)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (MESH_FRAMES, 720, 1280, 3), dtype=np.uint8)
    odd = frames[:3]
    rows = shard_rows(mesh, MESH_FRAMES).numpy()
    for p, n in ((pred, MESH_FRAMES), (pred, 3), (alone, len(rows)), (alone, 3)):
        p.warmup((720, 1280), n)
    torch.cuda.synchronize()
    reset_counts()
    got, _ = pred.predict_batch(frames)
    counts = read_counts()
    got_odd, _ = pred.predict_batch(odd)
    mine, _ = alone.predict_batch(frames[rows])
    mine_odd, _ = alone.predict_batch(odd)
    out = {"rows": rows.tolist(), "launches": counts,
           "shard_equal": all(np.array_equal(got[r], m) for r, m in zip(rows, mine)),
           "odd_equal": all(np.array_equal(g, m) for g, m in zip(got_odd, mine_odd)),
           "n_detections": int(sum(len(d) for d in got)),
           "digest": float(sum(d.astype(np.float64).sum() for d in got))}
    if mesh.is_main:
        alone.warmup((720, 1280), MESH_FRAMES)
        whole, _ = alone.predict_batch(frames)
        out["vs_b8_equal_images"] = sum(same_detections(w, g, 1e-5, 1e-3)
                                        for w, g in zip(whole, got))
        out["vs_b8_detections"] = [int(sum(len(w) for w in whole)), out["n_detections"]]
        out["vs_b8_matching"] = [
            sum(matching_detections(w, g, *tol) for w, g in zip(whole, got))
            for tol in ((1e-5, 1e-3), (1e-2, 2.0))]
    lat = [pred.predict_batch(frames)[1] for _ in range(30)]
    out["latency_ms"] = {"median": float(np.median(lat)), "p99": float(np.percentile(lat, 99))}
    lat = [alone.predict_batch(frames)[1] for _ in range(30)] if mesh.is_main else [0.0]
    out["alone_b8_latency_ms"] = float(np.median(lat))
    out["predict_s"] = time.perf_counter() - t0

    # the server over the mesh Predictor
    t0 = time.perf_counter()
    payloads = [(name, d) for name, m, d in svb.samples()   # the Huffman-coded JPEGs
                if m["shape"] is not None and name.endswith(".jpg") and m["kind"] not in
                ("jpeg_arith", "jpeg_lossless")]
    srv = InferenceServer(pred, batch_size=MESH_FRAMES, max_wait_ms=5.0, port=0)
    srv.start()
    reset_counts()
    if not mesh.is_main:
        srv.wait()   # until rank 0 stops the server
        out["server"] = {"launches": read_counts(), "batches": srv._stats()["batches"],
                         "port": srv.port}
        return out
    try:
        url = f"http://127.0.0.1:{srv.port}/predict"
        answers = [post(url, d) for _, d in payloads]
        stats = srv._stats()
    finally:
        srv.stop()
    launches = read_counts()
    one = InferenceServer(alone, batch_size=MESH_FRAMES // mesh.n_data, max_wait_ms=5.0,
                          port=0)
    one.start()
    try:
        url = f"http://127.0.0.1:{one.port}/predict"
        want = [post(url, d) for _, d in payloads]
    finally:
        one.stop()
    out["server"] = {
        "launches": launches, "batches": stats["batches"], "n": len(payloads),
        "all_200": all(a[0] == 200 for a in answers),
        "equal": [a == w for a, w in zip(answers, want)],
        "n_detections": int(sum(len(a[1].get("detections", [])) for a in answers)),
        "seconds": time.perf_counter() - t0}
    return out


def phase_ddp(smi: str) -> dict:
    """Data-parallel training on the card: a world of 1 over NCCL in a child
    process (ddp_world1), then two processes sharing the card over gloo on
    CUDA tensors (ddp_rank) on write_dataset's files. Returns each rank's
    greedy_nms launches in fit."""
    import subprocess
    import tempfile

    from vision_kit_tpu_torch.utils import loader_bench as lb

    t_phase = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    script = os.path.join(REPO, "chip_smoke.py")

    def result(stdout: str, tag: str) -> dict:
        lines = [ln for ln in stdout.splitlines() if ln.startswith(tag + " ")]
        check(lines, f"no {tag} line")
        return json.loads(lines[-1][len(tag) + 1:])

    r = subprocess.run([sys.executable, script, "--ddp-world1", str(free_port())],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"the world-1 run exited {r.returncode}: {r.stderr[-3000:]}")
    w1 = result(r.stdout, "DDP1")
    fails = mesh_step_failures(w1)
    check(not fails, "the NCCL world-1 step: " + "; ".join(fails))
    mesh_img_s, plain_img_s = w1["img_s"]["mesh"], w1["img_s"]["plain"]
    print(f"ddp: world 1 over {w1['backend']} (init_distributed, deterministic mode, "
          f"cuDNN): a v5s@640 b{DDP_BATCH} step under the mesh against the step without "
          f"it, in float64 {len(w1['metrics']['f64_disagreements'])} tensors beyond 1e-4 "
          f"of a tensor plus 2e-3 of its change (worst "
          f"{w1['metrics']['f64_worst']:.3g}x that), in f32 {w1['n_disagreements']} "
          f"{w1['disagreements'][:2]}; f32 worst error against the float64 step over that "
          f"tolerance, mesh {w1['metrics']['mesh_vs_f64']:.3f}, without "
          f"{w1['metrics']['plain_vs_f64']:.3f}; loss {w1['metrics']['mesh']['loss']:.6f} "
          f"vs {w1['metrics']['one_process']['loss']:.6f}; bf16 step b{DDP_BATCH}: mesh "
          + ", ".join(f"{v:.1f}" for v in mesh_img_s) + " img/s, without "
          + ", ".join(f"{v:.1f}" for v in plain_img_s) + f" img/s on {smi}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "ds")
        lb.write_dataset(data_dir, FIT_TRAIN, FIT_VAL)
        port = free_port()
        procs = [subprocess.Popen([sys.executable, script, "--ddp-rank", str(rank),
                                   str(port), data_dir, os.path.join(tmp, "run")],
                                  cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"ddp rank {rank} exited {p.returncode}: {err[-3000:]}")
        r0, r1 = (result(o, "DDP2") for o, _ in outs)
    fails = mesh_step_failures(r0)
    check(not fails, "the 2x32 gloo step: " + "; ".join(fails)
          + f"; losses {r0['metrics']['mesh']} and {r0['metrics']['one_process']}")
    check(r0["digest"] == r1["digest"], "the ranks' states differ after fit")
    check(r0["last_is_orbax"] and r1["last_is_orbax"] and r0["saves"] > 0
          and r1["saves"] == 0,
          f"ckpts/last after the ddp fit: rank 0 found an orbax directory "
          f"{r0['last_is_orbax']} ({r0['saves']} saves), rank 1 {r1['last_is_orbax']} "
          f"({r1['saves']} saves)")
    want_steps = FIT_EPOCHS * FIT_TRAIN // DDP_BATCH
    check(r0["step"] == r1["step"] == want_steps, f"fit ended at step {r0['step']}")
    n_val = r0["n_val_batches"]
    for r in (r0, r1):
        check(r["launches"] == {"greedy_nms": FIT_EPOCHS * n_val, "head_scores": 0},
              f"rank {r['rank']} launched {r['launches']} in fit, not one greedy_nms per "
              f"validation batch ({FIT_EPOCHS} x {n_val})")
    val = r0["validate"]
    check(val["n_batches"][0] == val["n_batches"][1] and val["same_detections"],
          f"the 2-rank validation's detections differ from rank 0's alone "
          f"({val['n_batches']} batches; class exact, score 1e-5, box 1e-3 px)")
    check(val["max_diff"] <= 1e-9,
          f"2-rank validation metrics differ from one rank's by {val['max_diff']}")
    m0 = r0["metrics"]
    print(f"ddp: 2 ranks on the card over gloo with CUDA tensors (deterministic mode, "
          f"cuDNN): the v5s@640 2x32 step against the 1x64 step, in float64 "
          f"{len(m0['f64_disagreements'])} tensors beyond 1e-4 + 2e-3 of its change "
          f"(worst {m0['f64_worst']:.3g}x that), in f32 {r0['n_disagreements']}; f32 worst "
          f"error against the float64 step, 2x32 {m0['mesh_vs_f64']:.3f}, 1x64 "
          f"{m0['plain_vs_f64']:.3f}, each rank's 32 rows alone without a mesh "
          + ", ".join(f"{v:.3f}" for v in m0["alone_vs_f64"])
          + f"; loss {r0['metrics']['mesh']['loss']:.6f} "
          f"vs {r0['metrics']['one_process']['loss']:.6f}; bf16 step 2x32 "
          f"{r0['step_ms']:.1f} / {r1['step_ms']:.1f} ms ({r0['step_img_s']:.1f} img/s of "
          f"the global batch); Trainer.fit v5s@640 bf16 b{DDP_BATCH} (32 a rank), "
          f"{FIT_EPOCHS} epochs of {want_steps // FIT_EPOCHS} steps: {r0['fit_s']:.1f} s, "
          f"per epoch " + "; ".join(f"{e['img_s']:.1f} img/s ({e['seconds']:.2f} s), "
                                    f"validation {e['val_s']:.2f} s" for e in r0["epochs"])
          + f"; the ranks bit-identical; greedy_nms launches by rank "
          f"{[r0['launches']['greedy_nms'], r1['launches']['greedy_nms']]} "
          f"({FIT_EPOCHS} validations of {n_val} batch); rank 0's {r0['saves']} background "
          f"saves, ckpts/last an orbax directory on both ranks; validation on 2 ranks "
          f"{val['mesh']} vs rank 0 alone {val['one']}: detections "
          f"{'bit-equal' if val['bit_equal'] else 'equal within tolerance'} "
          f"({val['n_detections']}), "
          f"largest metric difference {val['max_diff']:.3g} on {smi}", flush=True)
    mesh_serving_checks(r0, r1, smi)
    print(f"ddp: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"greedy_nms": [r0["launches"]["greedy_nms"], r1["launches"]["greedy_nms"]],
            "serve": [r0["serve"]["server"]["launches"], r1["serve"]["server"]["launches"]]}


def mesh_serving_checks(r0: dict, r1: dict, smi: str) -> None:
    """The ddp ranks' mesh_serving results: each rank's rows equal the same
    rows run alone exactly, every rank holds the same whole batch, each
    kernel launched once a rank a request, the server's answers equal the
    one-process server's on the same shard."""
    s0, s1 = r0["serve"], r1["serve"]
    for r, s in ((r0, s0), (r1, s1)):
        check(s["shard_equal"], f"rank {r['rank']}: its rows {s['rows']} of the mesh batch "
              "differ from the same rows run alone")
        check(s["odd_equal"], f"rank {r['rank']}: the 3-frame batch differs from one "
              "process running it whole")
        check(s["launches"] == {"greedy_nms": 1, "head_scores": 1},
              f"rank {r['rank']}: a mesh request launched {s['launches']}")
    check(s0["rows"] == [0, 1, 2, 3] and s1["rows"] == [4, 5, 6, 7],
          f"the ranks ran rows {s0['rows']} and {s1['rows']}")
    check(s0["digest"] == s1["digest"] and s0["n_detections"] == s1["n_detections"] > 0,
          "the ranks hold different gathered detections")
    srv0, srv1 = s0["server"], s1["server"]
    check(srv0["all_200"] and all(srv0["equal"]),
          f"the mesh server's answers differ from the one-process server's: "
          f"{srv0['equal']}")
    check(srv1["port"] is None and srv1["batches"] == srv0["batches"] == srv0["n"],
          f"rank 1 followed {srv1['batches']} of rank 0's {srv0['batches']} batches")
    for name, srv in (("rank 0", srv0), ("rank 1", srv1)):
        want = {"greedy_nms": srv["batches"], "head_scores": srv["batches"]}
        check(srv["launches"] == want, f"the mesh server's {name} launched "
              f"{srv['launches']}, not one of each a batch")
    print(f"ddp: mesh serving, v5s@640 bf16 (calibrated head) behind Predictor(mesh=...) "
          f"on 2 gloo ranks sharing the card: {MESH_FRAMES} frames of 720x1280, rows "
          f"{s0['rows']} and {s1['rows']}, each rank's equal to the same rows run alone "
          f"(bit for bit), both ranks holding the whole batch ({s0['n_detections']} "
          f"detections); against one process at b{MESH_FRAMES} (bf16 convs round by the "
          f"rows a call gets): {s0['vs_b8_equal_images']} of {MESH_FRAMES} images equal, "
          f"{s0['vs_b8_matching'][0]} of {s0['vs_b8_detections'][0]} detections matching "
          f"(class exact, score 1e-5, box 1e-3 px), {s0['vs_b8_matching'][1]} within score "
          f"1e-2 and box 2 px (mesh {s0['vs_b8_detections'][1]}); 3 "
          f"frames run whole on each rank, equal to one process; launches a request by "
          f"rank {[s0['launches'], s1['launches']]}; request latency median "
          f"{s0['latency_ms']['median']:.3f} ms, p99 {s0['latency_ms']['p99']:.3f} ms "
          f"(rank 0, host clock; one process at b{MESH_FRAMES} on the same card "
          f"{s0['alone_b8_latency_ms']:.3f} ms); {s0['predict_s']:.1f} s", flush=True)
    print(f"ddp: InferenceServer over the mesh Predictor (rank 0 binds HTTP, rank 1 "
          f"follows): {srv0['n']} committed sample JPEGs one at a time, every answer "
          f"equal to a one-process server's at batch {MESH_FRAMES // 2} on the same card "
          f"({srv0['n_detections']} detections); batches by rank "
          f"{[srv0['batches'], srv1['batches']]}, launches by rank "
          f"{[srv0['launches'], srv1['launches']]}; {srv0['seconds']:.1f} s on {smi}",
          flush=True)


SPATIAL_FRAMES = 8      # a spatial batch request: 8 frames of 720x1280, whole on each rank
SPATIAL_STEP_BATCH = 8  # the spatial train step's batch (v5s@640, whole on each rank)
SPATIAL_STEP_REL = 1e-9
# bf16 spatial detections matching one process's (class exact, score 1e-2,
# box 2 px): convolutions on a band-plus-halo shape round otherwise, and an
# NMS decision near its threshold then flips (PR 11's mesh serving: 2391 of
# 2400 for 4-row calls against the 8-row call)
SPATIAL_BF16_MATCH = 0.99


def spatial_maps(model, mesh, frames: torch.Tensor, banded_run: bool):
    """The raw head maps of `model` on letterboxed frames (as Predictor
    feeds it), banded over the mesh's model axis or whole, in f32."""
    from vision_kit_tpu_torch.ops.letterbox import letterbox_device
    from vision_kit_tpu_torch.parallel.spatial import banded

    with torch.inference_mode():
        x, _ = letterbox_device(frames, (640, 640))
        if banded_run:
            with banded(mesh, 640) as bands:
                raws = model(bands.rows(x), decode=False)
        else:
            raws = model(x, decode=False)
    return [r.float() for r in raws]


def maps_error(got, want) -> float:
    """The largest error of raw maps over the largest magnitude of their
    level, over the levels."""
    return max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


def answer_rows(answer) -> np.ndarray:
    """A /predict answer's detections as (n, 6) rows."""
    dets = answer[1].get("detections", [])
    return np.array([d["box"] + [d["score"], d["class"]] for d in dets],
                    np.float64).reshape(-1, 6)


def step_relative_error(want: dict, got: dict, before: dict) -> float:
    """The largest error of a step's state over the step's change in the
    tensor (tensors the step leaves alone must be equal): a ratio."""
    from vision_kit_tpu_torch.utils.stream_bench import STATE_PARTS

    worst = 0.0
    for part in STATE_PARTS:
        for k, w in want[part].items():
            err = float((got[part][k] - w).abs().max())
            change = float((w - before[part][k]).abs().max())
            worst = max(worst, err / change if change > 0 else (0.0 if err == 0 else 1e30))
    return worst


def request_collectives(pred, frames: np.ndarray, mesh) -> dict:
    """Where a spatial request's time goes: the all-reduces one request
    makes (halos and the gather) and their bytes, and the ms of one such
    all-reduce alone over the model axis (a stem-level halo buffer, bf16,
    over gloo with CUDA tensors), mean of 50."""
    import torch.distributed as dist

    from vision_kit_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group

    sizes = []
    plain = dist.all_reduce

    def counting(t, *args, **kwargs):
        sizes.append(t.numel() * t.element_size())
        return plain(t, *args, **kwargs)

    dist.all_reduce = counting
    try:
        pred.predict_batch(frames)
    finally:
        dist.all_reduce = plain
    group = axis_group(mesh, MODEL_AXIS)
    buf = torch.zeros((2, 2, 1, 32, 1, 320), dtype=torch.bfloat16, device=mesh.device)
    for _ in range(5):
        dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    return {"per_request": len(sizes), "bytes": int(sum(sizes)),
            "largest_bytes": int(max(sizes)),
            "ms_each": (time.perf_counter() - t0) * 1000 / 50}


def spatial_rank(rank: int, port: int) -> dict:
    """`python3 chip_smoke.py --spatial-rank RANK PORT`, one of two processes
    sharing the card over gloo with CUDA tensors as a 1x2 mesh (n_model 2,
    deterministic mode): the spatial serving path, its server, the spatial
    train step and v7's spatial eval, each against one process running the
    same thing unsharded on the same card (see phase_spatial)."""
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.parallel import init_distributed, make_mesh
    from vision_kit_tpu_torch.parallel.mesh import barrier, broadcast_
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.serve import InferenceServer
    from vision_kit_tpu_torch.train.losses import YoloLoss
    from vision_kit_tpu_torch.train.optim import make_optimizer
    from vision_kit_tpu_torch.train.step import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )
    from vision_kit_tpu_torch.utils import serve_bench as svb
    from vision_kit_tpu_torch.utils import stream_bench as sb

    sb.deterministic()
    check(init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo"),
          "init_distributed did not join")
    try:
        mesh = make_mesh(n_model=2)
        check(mesh.shape == {"data": 1, "model": 2} and mesh.model_index == rank,
              f"rank {rank}: mesh {mesh.shape}, model index {mesh.model_index}")
        res = {"rank": rank}
        t0 = time.perf_counter()

        # 1. Predictor(spatial=True), v5s@640 bf16, calibrated head
        model = build_model(v5s_config(), device=mesh.device, dtype=torch.bfloat16, seed=0)
        sb.calibrate_head(model, 640, seed=1)
        broadcast_(mesh, [*model.parameters(), *model.buffers()])
        f32 = build_model(v5s_config(), device=mesh.device, seed=0)
        f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
        pred = Predictor(model, img_size=640, mesh=mesh, spatial=True)
        alone = Predictor(model, img_size=640, device=mesh.device)
        rng = np.random.default_rng(5)
        frames = rng.integers(0, 255, (SPATIAL_FRAMES, 720, 1280, 3), dtype=np.uint8)
        one = frames[:1]
        for p in (pred, alone):
            p.warmup((720, 1280), 1)
            p.warmup((720, 1280), SPATIAL_FRAMES)
        torch.cuda.synchronize()
        launches = {}
        got = {}
        for name, imgs in (("single", one), ("batch", frames)):
            reset_counts()
            got[name], _ = pred.predict_batch(imgs)
            launches[name] = read_counts()
        want = {name: alone.predict_batch(imgs)[0]
                for name, imgs in (("single", one), ("batch", frames))}
        # bf16 detections as sets: class exact, score 1e-2, box 2 px
        tol = (1e-2, 2.0)
        res["predict"] = {
            "launches": launches,
            "n_detections": {k: int(sum(len(d) for d in v)) for k, v in got.items()},
            "n_want": {k: int(sum(len(d) for d in v)) for k, v in want.items()},
            "matching": {k: int(sum(matching_detections(w, g, *tol)
                                    for w, g in zip(want[k], got[k]))) for k in got},
            "equal_images": {k: int(sum(sb.same_detections(w, g, *tol)
                                        for w, g in zip(want[k], got[k]))) for k in got},
            "digest": float(sum(d.astype(np.float64).sum() for d in got["batch"]))}
        # the raw maps against one process's: bf16, and f32 against f32
        dev_frames = torch.from_numpy(frames[:2]).to(mesh.device)
        ref32 = spatial_maps(f32, mesh, dev_frames, False)
        res["maps"] = {
            "bf16_spatial_vs_f32": maps_error(spatial_maps(model, mesh, dev_frames, True),
                                              ref32),
            "bf16_whole_vs_f32": maps_error(spatial_maps(model, mesh, dev_frames, False),
                                            ref32),
            "f32_spatial_vs_f32": maps_error(spatial_maps(f32, mesh, dev_frames, True),
                                             ref32)}
        # f32 detections against one process, to a stated tolerance
        pred32 = Predictor(f32, img_size=640, mesh=mesh, spatial=True)
        alone32 = Predictor(f32, img_size=640, device=mesh.device)
        g32, _ = pred32.predict_batch(frames[:2])
        w32, _ = alone32.predict_batch(frames[:2])
        res["predict_f32"] = {
            "equal_images": int(sum(sb.same_detections(w, g, 1e-4, 1e-2)
                                    for w, g in zip(w32, g32))),
            "matching": int(sum(matching_detections(w, g, 1e-4, 1e-2)
                                for w, g in zip(w32, g32))),
            "n_want": int(sum(len(w) for w in w32))}
        del pred32, alone32
        # request latency, one frame and eight, spatial and one process in turns
        lat = {"spatial_1": [], "alone_1": [], "spatial_8": [], "alone_8": []}
        for n, imgs in ((1, one), (SPATIAL_FRAMES, frames)):
            for name in ("spatial", "alone", "alone", "spatial"):
                p = pred if name == "spatial" else alone
                if name == "alone" and not mesh.is_main:
                    continue
                lat[f"{name}_{n}"] += [p.predict_batch(imgs)[1] for _ in range(15)]
        res["latency_ms"] = {k: float(np.median(v)) for k, v in lat.items() if v}
        res["collectives"] = request_collectives(pred, one, mesh)
        res["predict_s"] = time.perf_counter() - t0

        # 2. InferenceServer over the spatial Predictor
        t1 = time.perf_counter()
        payloads = [(name, d) for name, m, d in svb.samples()   # Huffman-coded JPEGs
                    if m["shape"] is not None and name.endswith(".jpg") and m["kind"] not in
                    ("jpeg_arith", "jpeg_lossless")]
        srv = InferenceServer(pred, batch_size=1, max_wait_ms=5.0, port=0)
        srv.start()
        reset_counts()
        if not mesh.is_main:
            srv.wait()
            res["server"] = {"launches": read_counts(), "batches": srv._stats()["batches"],
                             "port": srv.port}
        else:
            try:
                url = f"http://127.0.0.1:{srv.port}/predict"
                answers = [post(url, d) for _, d in payloads]
                stats = srv._stats()
            finally:
                srv.stop()
            srv_launches = read_counts()
            single = InferenceServer(alone, batch_size=1, max_wait_ms=5.0, port=0)
            single.start()
            try:
                url = f"http://127.0.0.1:{single.port}/predict"
                ones = [post(url, d) for _, d in payloads]
            finally:
                single.stop()
            res["server"] = {
                "launches": srv_launches, "batches": stats["batches"], "n": len(payloads),
                "all_200": all(a[0] == 200 for a in answers),
                "n_detections": int(sum(len(answer_rows(a)) for a in answers)),
                "n_want": int(sum(len(answer_rows(a)) for a in ones)),
                "matching": int(sum(matching_detections(answer_rows(w), answer_rows(a),
                                                        *tol)
                                    for w, a in zip(ones, answers)))}
        res["server"]["seconds"] = time.perf_counter() - t1
        del pred, alone, srv, model, f32
        torch.cuda.empty_cache()

        # 3. the spatial train step against the unsharded one, float64 and f32
        t1 = time.perf_counter()
        cfg = v5s_config()
        net = build_model(cfg, device=mesh.device, seed=0)
        start = {k: v.clone() for k, v in net.state_dict().items()}
        rng = np.random.default_rng(6)
        batch = {"image": torch.from_numpy(rng.integers(
                     0, 255, (SPATIAL_STEP_BATCH, 640, 640, 3), dtype=np.uint8)),
                 "targets": torch.from_numpy(sb.bench_targets(rng, SPATIAL_STEP_BATCH))}
        batch = {k: v.to(mesh.device) for k, v in batch.items()}
        runs = {}
        plan = [("spatial", d) for d in (torch.float64, torch.float32)]
        if mesh.is_main:
            plan += [("whole", d) for d in (torch.float64, torch.float32)]
        for name, dtype in plan:
            net.load_state_dict(start)
            net.to(dtype)
            tx = make_optimizer(net, sb.TRAIN_HYP, 3, 10)
            m = mesh if name == "spatial" else None
            state = create_train_state(net, tx, mesh=m)
            before = sb.train_state_tensors(state, torch.float64)
            loss = YoloLoss(80, net.head.grid_anchors, sb.TRAIN_HYP, layout="native")
            step = make_train_step(net, loss, tx, mesh=m, spatial=name == "spatial")
            state, metrics = step(state, batch)
            runs[name, dtype] = (sb.train_state_tensors(state, torch.float64),
                                 {k: float(v) for k, v in metrics.items()}, before)
            del state, tx, step
            torch.cuda.empty_cache()
        f64 = torch.float64
        if mesh.is_main:
            exact = runs["whole", f64]
            sp64 = runs["spatial", f64]
            res["step"] = {
                "f64_state_rel": step_relative_error(exact[0], sp64[0], exact[2]),
                "f64_metric_rel": max(abs(sp64[1][k] / exact[1][k] - 1) for k in exact[1]),
                "f32_spatial_vs_f64": sb.worst_step_error(
                    exact[0], runs["spatial", torch.float32][0], exact[2]),
                "f32_whole_vs_f64": sb.worst_step_error(
                    exact[0], runs["whole", torch.float32][0], exact[2]),
                "loss": [sp64[1]["loss"], exact[1]["loss"]]}
        res["step_digest"] = float(sum(float(t.double().sum())
                                       for t in runs["spatial", f64][0]["params"].values()))
        res["step_s"] = time.perf_counter() - t1
        del net, runs
        torch.cuda.empty_cache()

        # 4. v7 base@128 spatial eval: SPPCSPC's 13-pool halo (6 rows) outgrows
        # the 2-row bands of the stride-32 map
        t1 = time.perf_counter()
        _, v7 = folded_v7(128, str(mesh.device))
        broadcast_(mesh, [*v7.parameters(), *v7.buffers()])
        imgs = np.random.default_rng(7).integers(0, 255, (4, 128, 128, 3), dtype=np.uint8)
        x = torch.from_numpy(imgs).to(mesh.device)
        reset_counts()
        gd, gv = make_eval_step(v7, mesh=mesh, spatial=True)(x)
        v7_launches = read_counts()
        wd, wv = make_eval_step(v7)(x)
        gd, gv, wd, wv = (t.cpu().numpy() for t in (gd, gv, wd, wv))
        res["v7_eval"] = {
            "launches": v7_launches,
            "equal_images": int(sum(sb.same_detections(wd[i][wv[i]], gd[i][gv[i]], 1e-4,
                                                        1e-2, box_rtol=1e-4)
                                    for i in range(len(wv)))),
            "n": len(wv), "n_detections": int(wv.sum()),
            "matching": int(sum(matching_detections(wd[i][wv[i]], gd[i][gv[i]], 1e-4, 1e-2)
                                for i in range(len(wv))))}
        res["v7_s"] = time.perf_counter() - t1
        barrier(mesh)
        res["seconds"] = time.perf_counter() - t0
        return res
    finally:
        torch.distributed.destroy_process_group()


def phase_spatial(smi: str) -> dict:
    """Spatial partitioning on the card (the mesh's model axis;
    parallel/spatial.py): two processes sharing the card over gloo on CUDA
    tensors as a 1x2 mesh (spatial_rank), in deterministic mode.

    1. Predictor(spatial=True), v5s@640 bf16 (calibrated head), on 1 frame
       of 720x1280 and on 8: each kernel launched once a rank a request;
       each rank's detections against one process's on the same card as
       detection sets, as many and SPATIAL_BF16_MATCH of them matching
       (class exact, score 1e-2, box 2 px: bf16 convolutions on a
       band-plus-halo shape take other algorithms, so bit equality is not
       expected); the raw maps of the bf16 spatial run no further from
       the f32 unsharded maps than twice the bf16 unsharded run's; the f32
       spatial maps within 1e-5 of the f32 unsharded ones and the f32
       detections equal (score 1e-4, box 1e-2 px); the request latency,
       spatial and one process in turns (one card: no gain to show);
    2. InferenceServer over that Predictor (rank 0 binds HTTP, rank 1
       follows) answering each committed sample JPEG as a one-process
       server over the same model, every detection matching (as in 1);
    3. the v5s@640 spatial train step (b8, whole images on each rank) against
       the unsharded step: in float64 every state tensor within 1e-9 of the
       step's change in it and the metrics within 1e-9, where neither
       cuDNN's nor the max pools' rounding can hide a halo or gather fault;
       in f32 each step's worst error against the float64 step, reported
       (worst_step_error: 1 is test_torch_train.py's tolerance);
    4. v7 base@128 (f32, folded, calibrated) make_eval_step(spatial=True) on
       4 frames, whose SPPCSPC 13-pool halo outgrows the stride-32 bands,
       against the unsharded eval step: detections equal (score 1e-4, box
       1e-2 px + 1e-4 of the box), one greedy_nms launch a rank.
    Returns each rank's single-frame request launches."""
    import subprocess

    t_phase = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    script = os.path.join(REPO, "chip_smoke.py")
    port = free_port()
    procs = [subprocess.Popen([sys.executable, script, "--spatial-rank", str(rank), str(port)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"spatial rank {rank} exited {p.returncode}: {err[-3000:]}")
    r0, r1 = ([json.loads(ln[len("SPATIAL "):]) for ln in o.splitlines()
               if ln.startswith("SPATIAL ")][-1] for o, _ in outs)
    print("spatial: " + json.dumps({"rank0": r0, "rank1": r1}), flush=True)
    p0, p1 = r0["predict"], r1["predict"]
    for r in (r0, r1):
        p = r["predict"]
        for name in ("single", "batch"):
            check(p["launches"][name] == {"greedy_nms": 1, "head_scores": 1},
                  f"rank {r['rank']}: a spatial {name} request launched {p['launches'][name]}")
            want = p["n_want"][name]
            check(p["n_detections"][name] == want > 0
                  and p["matching"][name] >= SPATIAL_BF16_MATCH * want,
                  f"rank {r['rank']}: spatial {name} detections differ from one process's: "
                  f"{p['matching'][name]} of {want} matching (class exact, score 1e-2, box "
                  f"2 px), {p['n_detections'][name]} detections")
        m = r["maps"]
        check(m["bf16_spatial_vs_f32"] <= 2 * m["bf16_whole_vs_f32"],
              f"rank {r['rank']}: the bf16 spatial maps lie {m['bf16_spatial_vs_f32']:.3g} "
              f"from f32, beyond twice the unsharded bf16 maps' {m['bf16_whole_vs_f32']:.3g}")
        check(m["f32_spatial_vs_f32"] <= 1e-5,
              f"rank {r['rank']}: f32 spatial maps {m['f32_spatial_vs_f32']:.3g} from unsharded")
        check(r["predict_f32"]["equal_images"] == 2,
              f"rank {r['rank']}: f32 spatial detections differ from one process's: "
              f"{r['predict_f32']}")
        check(r["v7_eval"]["launches"] == {"greedy_nms": 1, "head_scores": 0}
              and r["v7_eval"]["equal_images"] == r["v7_eval"]["n"]
              and r["v7_eval"]["n_detections"] > 0,
              f"rank {r['rank']}: v7 spatial eval {r['v7_eval']}")
    check(p0["digest"] == p1["digest"], "the ranks hold different spatial detections")
    check(r0["step_digest"] == r1["step_digest"], "the ranks' spatial step states differ")
    srv0, srv1 = r0["server"], r1["server"]
    check(srv0["all_200"] and srv0["n_detections"] == srv0["n_want"] == srv0["matching"] > 0,
          f"the spatial server's answers differ from the one-process server's: {srv0}")
    check(srv1["port"] is None and srv1["batches"] == srv0["batches"] == srv0["n"],
          f"rank 1 followed {srv1['batches']} of rank 0's {srv0['batches']} batches")
    for name, srv in (("rank 0", srv0), ("rank 1", srv1)):
        check(srv["launches"] == {"greedy_nms": srv["batches"], "head_scores": srv["batches"]},
              f"the spatial server's {name} launched {srv['launches']}")
    st = r0["step"]
    check(st["f64_state_rel"] <= SPATIAL_STEP_REL and st["f64_metric_rel"] <= SPATIAL_STEP_REL,
          f"the float64 spatial step differs from the unsharded step: state "
          f"{st['f64_state_rel']:.3g} of the step's change, metrics {st['f64_metric_rel']:.3g}")
    lat = r0["latency_ms"]
    print(f"spatial: v5s@640 bf16 Predictor(spatial=True) on a 1x2 mesh (2 gloo ranks sharing "
          f"the card): launches a request by rank {[p0['launches'], p1['launches']]}; "
          f"detections against one process (class exact, score 1e-2, box 2 px; images "
          f"equal {p0['equal_images']}): 1 frame "
          f"{p0['matching']['single']} of {p0['n_want']['single']}, {SPATIAL_FRAMES} frames "
          f"{p0['matching']['batch']} of {p0['n_want']['batch']} matching; raw maps' error "
          f"over their largest, bf16 spatial {r0['maps']['bf16_spatial_vs_f32']:.3g} and "
          f"unsharded {r0['maps']['bf16_whole_vs_f32']:.3g} from f32, f32 spatial "
          f"{r0['maps']['f32_spatial_vs_f32']:.3g}; f32 detections "
          f"{r0['predict_f32']['matching']} of {r0['predict_f32']['n_want']} equal; request "
          f"latency median (host clock, rank 0): 1 frame spatial {lat['spatial_1']:.3f} ms, "
          f"one process {lat['alone_1']:.3f} ms; {SPATIAL_FRAMES} frames spatial "
          f"{lat['spatial_8']:.3f} ms, one process {lat['alone_8']:.3f} ms (two ranks on one "
          f"card: no latency gain to show); a 1-frame request makes "
          f"{r0['collectives']['per_request']} all-reduces over the model axis "
          f"({r0['collectives']['bytes']} bytes, the gather {r0['collectives']['largest_bytes']}"
          f"), a stem-level halo's alone {r0['collectives']['ms_each']:.3f} ms; "
          f"{r0['predict_s']:.1f} s on {smi}", flush=True)
    print(f"spatial: InferenceServer over the spatial Predictor, {srv0['n']} sample JPEGs: "
          f"{srv0['matching']} of {srv0['n_want']} detections of the one-process server "
          f"matching; batches by rank {[srv0['batches'], srv1['batches']]}, launches by rank "
          f"{[srv0['launches'], srv1['launches']]}; {srv0['seconds']:.1f} s", flush=True)
    print(f"spatial: v5s@640 train step b{SPATIAL_STEP_BATCH} on 1x2 against unsharded: "
          f"float64 state error {st['f64_state_rel']:.3g} of the step's change, metrics "
          f"{st['f64_metric_rel']:.3g} (loss {st['loss'][0]:.12f} vs {st['loss'][1]:.12f}); "
          f"f32 worst error against float64 over the step tolerance: spatial "
          f"{st['f32_spatial_vs_f64']:.3f}, unsharded {st['f32_whole_vs_f64']:.3f}; "
          f"{r0['step_s']:.1f} s", flush=True)
    v = r0["v7_eval"]
    print(f"spatial: v7 base@128 f32 make_eval_step(spatial=True) on 4 frames: "
          f"{v['equal_images']} of {v['n']} images equal to unsharded ({v['n_detections']} "
          f"detections), launches by rank {[r0['v7_eval']['launches'], r1['v7_eval']['launches']]}"
          f"; {r0['v7_s']:.1f} s", flush=True)
    print(f"spatial: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {name: [r["predict"]["launches"]["single"][name] for r in (r0, r1)]
            for name in ("greedy_nms", "head_scores")}


def sync_points(fn) -> dict:
    """Where `fn` makes the host wait for the card: torch's sync debug mode
    warns at each synchronising call; returns {file:line: count}."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
            out[key] = out.get(key, 0) + 1
    return out


def profile_train(smi: str) -> None:
    """Device time of 3 training steps by kernel group and by the step's
    profiler ranges, with the idle share and the convolutions' bound (3x
    the forward's conv FLOP at the bf16 peak): v5s b64, v5s b64 with
    device augmentation, v7 base b16 with SimOTA."""
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.train.losses import YoloLoss
    from vision_kit_tpu_torch.train.ota import YoloLossOTA
    from vision_kit_tpu_torch.utils import stream_bench as sb

    for name, make, loss_cls, batch, kw in (
            ("v5s@640 b64", calibrated_v5s, YoloLoss, TRAIN_BATCH, {}),
            ("v5s@640 b64 daug", calibrated_v5s, YoloLoss, TRAIN_BATCH, {"device_aug": True}),
            ("v7 base@640 b16 OTA", lambda: build_model(v7_config(False), device="cuda",
                                                         seed=0),
             YoloLossOTA, V7_TRAIN_BATCH, {})):
        model = make()
        flops = conv_flops(model, torch.zeros(batch, 640, 640, 3, dtype=torch.uint8,
                                              device="cuda"))
        step, state, data = sb.train_bench_setup(
            model, loss_cls(80, model.head.grid_anchors, sb.TRAIN_HYP), batch, **kw)
        holder = [state]

        def run():
            holder[0] = step(holder[0], data)[0]

        prof = profile_device(run, 3, TRAIN_PROFILE_GROUPS, TRAIN_RANGES)
        if "wall_ms" in prof:
            prof.update(conv_gflop=3 * flops / 1e9,
                        conv_bound_ms=3 * flops / H100_BF16_FLOP_S * 1e3)
        print(f"profile: train step {name} bf16, per step, device ms by kernel group "
              f"and range on {smi}: " + json.dumps(prof), flush=True)
        del model, step, holder, data
        torch.cuda.empty_cache()


ORBAX_BATCH = 16      # the TrainState's two training steps
ORBAX_FIT_BATCH = 8   # the resumed Trainers' batch


def orbax_config(data_dir: str, out: str):
    """fit_config for 80 classes at batch ORBAX_FIT_BATCH: a Trainer whose
    state is the orbax phase's v5s@640 TrainState's shape."""
    from vision_kit_tpu_torch.classes.coco import COCO

    cfg = fit_config(data_dir, out, epochs=1)
    cfg.model.num_classes = 80
    cfg.data.update(batch_size=ORBAX_FIT_BATCH, class_labels=list(COCO))
    return cfg


def orbax_resume(ckpt: str, pt: str, data_dir: str, out: str) -> dict:
    """`python3 chip_smoke.py --orbax-resume CKPT PT DATA OUT`, a child with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 set before CUDA starts: two
    Trainer(deterministic=True)s of orbax_config, one restored by
    load_checkpoint from the JAX-layout orbax directory CKPT, the other from
    the port's own file PT of the same state; each then takes one train
    step on the batch its resume step names. Returns both resume steps,
    meta fields and state steps, and the state tensors that differ."""
    from vision_kit_tpu_torch.train.trainer import Trainer
    from vision_kit_tpu_torch.utils import stream_bench as sb
    from vision_kit_tpu_torch.utils import zstd

    out_: dict = {}
    with restored_determinism():
        trainers = {}
        for name, path in (("orbax", ckpt), ("pt", pt)):
            tr = Trainer(orbax_config(data_dir, os.path.join(out, name)),
                         use_tensorboard=False, seed=0, device="cuda", deterministic=True)
            calls = zstd.c_calls()
            t0 = time.perf_counter()
            start = tr.load_checkpoint(path)
            torch.cuda.synchronize()
            out_[name] = {"start": start, "load_s": time.perf_counter() - t0,
                          "zstd_calls": zstd.c_calls() - calls,
                          "best_map50": tr.best_map50,
                          "epochs_no_improve": tr.epochs_no_improve,
                          "restored_step": tr.state.step}
            trainers[name] = tr
        loader = trainers["orbax"].train_loader
        loader.close()
        loader.seek(out_["orbax"]["start"])
        batch = next(iter(loader))
        loader.close()
        for name, tr in trainers.items():
            tr.state, _ = tr._train_step_for(out_[name]["start"])(tr.state, batch)
            out_[name]["step"] = tr.state.step
            tr.train_loader.close()
        torch.cuda.synchronize()
        a, b = (sb.train_state_tensors(trainers[n].state) for n in ("orbax", "pt"))
    out_["differ"] = [f"{p} {k}" for p in sb.STATE_PARTS for k in a[p]
                      if not torch.equal(a[p][k], b[p][k])][:5]
    out_["tensors"] = sum(len(a[p]) for p in sb.STATE_PARTS)
    return out_


def phase_orbax(smi: str) -> dict:
    """The JAX Trainer's orbax checkpoints on the card, without orbax,
    tensorstore or zstandard (utils/zstd.py, utils/ocdbt.py,
    utils/orbax.py). (a) the host C decoder (csrc/zstd_decode.cu) on the
    committed frames and checkpoints of data/checkpoint_samples, byte-equal
    to the plain decoder and to the manifest's sha256, and its MB/s on the
    largest frame; (b) a v5s@640 TrainState with momentum and EMA (two
    steps from calibrated_v5s) written by write_checkpoint in the JAX
    layout (convert.jax_train_state_tree) with the JAX meta beside it, read
    back by read_checkpoint on the card's path, every tensor bit-equal, and
    the same state through the Trainer's AsyncCheckpointer (the caller's
    blocked ms, the writer's ms); (c) one b8 640 batch served through
    load_predictor_from_config of that directory and of the port's own
    file of the same state: detections
    bit-equal, both kernels launched; (d) in a child (--orbax-resume),
    Trainer.load_checkpoint of the directory and of the file, each followed
    by one train step: bit-equal, step and meta carried. Returns the
    launches of (c)'s orbax leg."""
    import hashlib
    import subprocess
    import tempfile

    from vision_kit_tpu_torch import convert
    from vision_kit_tpu_torch.predictor import load_predictor_from_config
    from vision_kit_tpu_torch.train.checkpoint import AsyncCheckpointer, save_checkpoint
    from vision_kit_tpu_torch.train.losses import YoloLoss
    from vision_kit_tpu_torch.utils import loader_bench as lb
    from vision_kit_tpu_torch.utils import orbax
    from vision_kit_tpu_torch.utils import stream_bench as sb
    from vision_kit_tpu_torch.utils import zstd

    t_phase = time.perf_counter()
    samples = os.path.join(REPO, "vision_kit_tpu_torch", "data", "checkpoint_samples")
    with open(os.path.join(samples, "MANIFEST.json")) as f:
        manifest = json.load(f)

    # (a) the committed frames and checkpoints
    calls = zstd.c_calls()
    for name, meta in manifest["frames"].items():
        with open(os.path.join(samples, name), "rb") as f:
            data = f.read()
        got = zstd.decompress(data, device="cuda")
        check(got == zstd.decompress(data), f"orbax: the C decoder differs from the plain "
              f"one on {name}")
        check(hashlib.sha256(got).hexdigest() == meta["content_sha256"],
              f"orbax: {name} decodes to other bytes than its manifest's")
    n_frames = zstd.c_calls() - calls
    check(n_frames == len(manifest["frames"]), f"orbax: {n_frames} C decoder calls for "
          f"{len(manifest['frames'])} frames")
    for layout in ("orbax_ocdbt", "orbax_plain"):
        path = os.path.join(samples, layout)
        card_tree, plain_tree = (orbax.read_checkpoint(path, device=d) for d in ("cuda", "cpu"))
        card_leaves, plain_leaves = flat_leaves(card_tree), flat_leaves(plain_tree)
        check(sorted(card_leaves) == sorted(manifest["leaves"]) == sorted(plain_leaves),
              f"orbax: {layout}'s leaves differ from the manifest's")
        for key, meta in manifest["leaves"].items():
            dtype, shape, raw = leaf_data(card_leaves[key])
            check((dtype, list(shape)) == (meta["dtype"], meta["shape"])
                  and leaf_data(plain_leaves[key]) == (dtype, shape, raw)
                  and hashlib.sha256(raw).hexdigest() == meta["sha256"],
                  f"orbax: {layout} {key} differs from the plain reader or the manifest")
    big = max(manifest["frames"], key=lambda n: manifest["frames"][n]["content_bytes"])
    with open(os.path.join(samples, big), "rb") as f:
        data = f.read()
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        zstd.decompress_c(data)
    c_mb_s = reps * manifest["frames"][big]["content_bytes"] / (time.perf_counter() - t0) / 1e6
    t0 = time.perf_counter()
    zstd.decompress(data)
    plain_mb_s = manifest["frames"][big]["content_bytes"] / (time.perf_counter() - t0) / 1e6
    print(f"orbax: the C decoder (csrc/zstd_decode.cu) on {n_frames} committed frames "
          f"byte-equal to the plain decoder and the manifest's sha256; both checkpoint "
          f"layouts (OCDBT, a {manifest['checkpoints']['orbax_ocdbt']['root_height'] + 1}"
          f"-level B-tree, and plain) read on the card equal to the plain reader and to "
          f"the manifest's {len(manifest['leaves'])} leaves; {big} "
          f"({manifest['frames'][big]['content_bytes']} bytes of content, "
          f"{len(data)} of zstd): C {c_mb_s:.1f} MB/s, plain {plain_mb_s:.2f} MB/s "
          f"(host clock, {reps} reps) on {smi}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        # (b) a full-width TrainState through write_checkpoint and read_checkpoint
        model = calibrated_v5s()
        step, state, data = sb.train_bench_setup(
            model, YoloLoss(80, model.head.grid_anchors, sb.TRAIN_HYP), ORBAX_BATCH)
        for _ in range(2):
            state, _ = step(state, data)
        torch.cuda.synchronize()
        ckpt = os.path.join(tmp, "ckpts", "last")
        pt = os.path.join(tmp, "last.pt")
        t0 = time.perf_counter()
        tree = convert.jax_train_state_tree(state)
        orbax.write_checkpoint(ckpt, tree)
        write_s = time.perf_counter() - t0
        meta = {"epoch": 0, "step": state.step, "best_map50": 0.125,
                "epochs_no_improve": 1, "val_pending": False}
        with open(ckpt + ".meta.json", "w") as f:
            json.dump(meta, f)
        save_checkpoint(pt, state, epoch=0, best_map50=0.125, epochs_no_improve=1)
        calls = zstd.c_calls()
        t0 = time.perf_counter()
        back = orbax.read_checkpoint(ckpt, device="cuda")
        read_s = time.perf_counter() - t0
        n_chunks = zstd.c_calls() - calls
        want, got = flat_leaves(tree), flat_leaves(back)
        check(sorted(want) == sorted(got), "orbax: the v5s TrainState's leaves differ "
              "after the round trip")
        mb = 0
        for key, leaf in want.items():
            raw = leaf_data(leaf)
            check(raw == leaf_data(got[key]), f"orbax: {key} differs after the round trip")
            mb += len(raw[2]) / 1e6
        check(n_chunks > 0, "orbax: the card's read never called the C decoder")
        print(f"orbax: v5s@640 TrainState after 2 steps (EMA {state.ema.updates} updates, "
              f"momentum) as the JAX Trainer's tree: {len(want)} leaves, {mb:.1f} MB, "
              f"write_checkpoint {write_s:.2f} s, read_checkpoint on the card's path "
              f"{read_s:.2f} s ({n_chunks} chunks through the C decoder), every leaf "
              f"bit-equal (host clock) on {smi}", flush=True)
        # the same state through the Trainer's background writer
        ckptr = AsyncCheckpointer()
        async_dir = os.path.join(tmp, "ckpts", "async")
        t0 = time.perf_counter()
        ckptr.save(async_dir, state, epoch=0)
        returned_s = time.perf_counter() - t0
        ckptr.wait_until_finished()
        rec = ckptr.records[-1]
        got = flat_leaves(orbax.read_checkpoint(async_dir, device="cuda"))
        check(sorted(got) == sorted(want)
              and all(leaf_data(got[k]) == leaf_data(w) for k, w in want.items()),
              "orbax: the background save differs from the state's tree")
        print(f"orbax: the same {mb:.1f} MB state through AsyncCheckpointer.save: the "
              f"caller blocked {rec['blocked_s'] * 1e3:.1f} ms on the snapshot (save "
              f"returned in {returned_s * 1e3:.1f} ms), the writer thread "
              f"{rec['write_s'] * 1e3:.1f} ms, against write_checkpoint's "
              f"{write_s * 1e3:.1f} ms above (snapshot and write); every leaf bit-equal "
              f"(host clock) on {smi}", flush=True)
        del step, state, data, tree, back, model
        torch.cuda.empty_cache()

        # (c) serving from the directory and from the port's file
        cfg = v5s_config()
        frames = np.random.default_rng(18).integers(0, 255, (8, 640, 640, 3), dtype=np.uint8)
        served = {}
        for name, path in (("orbax", ckpt), ("pt", pt)):
            t0 = time.perf_counter()
            pred = load_predictor_from_config(cfg, weights=path, device="cuda",
                                              dtype=torch.bfloat16, seed=3)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            pred.predict_batch(frames)
            dets, counts = serve_requests(pred, [frames])
            served[name] = (dets, counts, load_s)
            del pred
        (d_o, c_o, s_o), (d_p, c_p, s_p) = served["orbax"], served["pt"]
        check(c_o["greedy_nms"] > 0 and c_o["head_scores"] > 0 and c_o == c_p,
              f"orbax: serving launched {c_o} from the directory, {c_p} from the file")
        check(len(d_o) == len(d_p) == 8 and all(np.array_equal(a, b) for a, b in zip(d_o, d_p)),
              "orbax: detections from the directory differ from the file's")
        n_det = sum(len(d) for d in d_o)
        check(n_det > 0 and all(np.isfinite(d).all() for d in d_o), "orbax: no detections")
        print(f"orbax: load_predictor_from_config of the directory ({s_o:.2f} s) and of "
              f"the port's file ({s_p:.2f} s), v5s@640 bf16, one b8 640 batch: {n_det} "
              f"detections bit-equal, launches {c_o} (host clock) on {smi}", flush=True)

        # (d) Trainer.load_checkpoint and one step, in a deterministic child
        data_dir = os.path.join(tmp, "ds")
        lb.write_dataset(data_dir, 2 * ORBAX_FIT_BATCH, ORBAX_FIT_BATCH, png_only=True)
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                            "--orbax-resume", ckpt, pt, data_dir, os.path.join(tmp, "resume")],
                           cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("ORBAX ")]
        check(r.returncode == 0 and lines,
              f"orbax: the resume child exited {r.returncode}: {r.stderr[-2000:]}")
        res = json.loads(lines[-1][len("ORBAX "):])
        o, p = res["orbax"], res["pt"]
        check(res["differ"] == [], f"orbax: the resumed steps differ: {res['differ']}")
        check(o["start"] == p["start"] == meta["step"] and o["restored_step"] == meta["step"]
              and o["step"] == p["step"] == meta["step"] + 1,
              f"orbax: resume steps {o} against {p}")
        check((o["best_map50"], o["epochs_no_improve"]) == (0.125, 1) == (
            p["best_map50"], p["epochs_no_improve"]), f"orbax: meta not carried: {o}")
        check(o["zstd_calls"] > 0, "orbax: the resume never called the C decoder")
        print(f"orbax: Trainer(deterministic=True).load_checkpoint of the directory "
              f"({o['load_s']:.2f} s) and of the port's file ({p['load_s']:.2f} s), then one "
              f"train step each at b{ORBAX_FIT_BATCH}: {res['tensors']} state tensors "
              f"bit-equal, resumed at step {o['start']}, meta carried (child {child_s:.1f} s)",
              flush=True)
    print(f"orbax: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return c_o


def flat_leaves(tree, prefix=()) -> dict:
    """{str(path tuple): leaf} of a read_checkpoint tree (dicts, tuples),
    without its empty nodes."""
    if isinstance(tree, dict):
        return {k: v for key, child in tree.items()
                for k, v in flat_leaves(child, prefix + (str(key),)).items()}
    if isinstance(tree, tuple):
        return {k: v for i, child in enumerate(tree)
                for k, v in flat_leaves(child, prefix + (str(i),)).items()}
    return {} if tree is None else {str(prefix): tree}


def leaf_data(leaf) -> tuple:
    """(dtype name, shape, bytes) of an array leaf (bfloat16 through int16)."""
    if isinstance(leaf, torch.Tensor):
        return "bfloat16", tuple(leaf.shape), leaf.view(torch.int16).numpy().tobytes()
    arr = np.asarray(leaf)
    return str(arr.dtype), arr.shape, arr.tobytes()


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--deterministic-check":
        if not torch.cuda.is_available():
            return 1
        sys.path.insert(0, REPO)
        res = deterministic_check(sys.argv[2], sys.argv[3])
        print("DETERMINISTIC " + json.dumps(res), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--ddp-world1":
        if not torch.cuda.is_available():
            return 1
        sys.path.insert(0, REPO)
        print("DDP1 " + json.dumps(ddp_world1(int(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) == 6 and sys.argv[1] == "--ddp-rank":
        if not torch.cuda.is_available():
            return 1
        sys.path.insert(0, REPO)
        res = ddp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        print("DDP2 " + json.dumps(res), flush=True)
        return 0
    if len(sys.argv) >= 5 and len(sys.argv) % 2 == 1 and sys.argv[1] == "--demo-video":
        if not torch.cuda.is_available():
            return 1
        sys.path.insert(0, REPO)
        print("VIDEO " + json.dumps(demo_video_child(*sys.argv[2:])), flush=True)
        return 0
    if len(sys.argv) == 6 and sys.argv[1] == "--orbax-resume":
        if not torch.cuda.is_available():
            return 1
        sys.path.insert(0, REPO)
        print("ORBAX " + json.dumps(orbax_resume(*sys.argv[2:6])), flush=True)
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--spatial-rank":
        if not torch.cuda.is_available():
            return 1
        sys.path.insert(0, REPO)
        res = spatial_rank(int(sys.argv[2]), int(sys.argv[3]))
        print("SPATIAL " + json.dumps(res), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "vision_kit_tpu_torch")):
        print("chip_smoke: vision_kit_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()

    from vision_kit_tpu_torch.utils.kernel_bench import card

    smi = card()
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, numpy {np.__version__}", flush=True)
    build_kernels()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.default_rng(0)
    head_max_err = phase_kernels(rng)
    model, counts = phase_main_path(rng, smi)

    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.utils.stream_bench import run_detector_bench

    as_built = build_model(v5s_config(), device="cuda", dtype=torch.bfloat16,
                           seed=0)
    for head, m in (("calibrated head", model), ("head as built", as_built)):
        reset_counts()
        rec = run_detector_bench(m, batch=128, size=640, iters=10, warmup=3)
        bench_counts = read_counts()
        for name, n in bench_counts.items():
            check(n > 0, f"throughput path never launched {name}")
        print(f"throughput: v5s@640 b128 bf16, {head}: {rec['value']:.1f} img/s "
              f"({rec['step_ms']:.3f} ms/step, {rec['detections']} detections "
              f"in 10 steps) on {smi}; launches {bench_counts}", flush=True)
    del as_built

    seconds = {"start to throughput": time.perf_counter() - t_start}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)
        return out

    eval_counts = timed("eval", phase_eval, model, rng, smi)
    v7, v7_counts = timed("v7", phase_v7, rng, smi)
    train_counts = timed("train", phase_train, rng, smi)
    ref_counts = timed("weights", phase_weights, model, rng, smi)
    timed("orbax", phase_orbax, smi)
    video_counts, demo_legs = timed("demo", phase_demo, model, smi)
    serve_counts = timed("serve", phase_serve, model, smi)
    fit_counts = timed("fit", phase_fit, smi)
    fit_host_counts = timed("fit-host", phase_fit_host, smi)
    ddp_counts = timed("ddp", phase_ddp, smi)
    spatial_counts = timed("spatial", phase_spatial, smi)

    from vision_kit_tpu_torch.train.step import make_eval_step
    from vision_kit_tpu_torch.utils.stream_bench import detector_step

    rows = kernel_times(head_max_err)
    anchors = torch.as_tensor(model.anchors_px, dtype=torch.float32, device="cuda")
    prof = profile_steps(model, lambda x: detector_step(model, x, anchors), batch=128)
    print("profile: v5s@640 b128 bf16, per step, device ms by kernel group: "
          + json.dumps(prof), flush=True)
    prof = profile_steps(model, make_eval_step(model), batch=64)
    print("profile: eval step v5s@640 b64 bf16, per step, device ms by kernel "
          "group: " + json.dumps(prof), flush=True)
    anchors = torch.as_tensor(v7.anchors_px, dtype=torch.float32, device="cuda")
    prof = profile_steps(v7, lambda x: detector_step(v7, x, anchors), batch=64)
    print("profile: v7 base@640 b64 bf16 deploy, per step, device ms by kernel "
          "group: " + json.dumps(prof), flush=True)
    prof = profile_steps(v7, make_eval_step(v7), batch=64)
    print("profile: eval step v7 base@640 b64 bf16 deploy, per step, device ms "
          "by kernel group: " + json.dumps(prof), flush=True)
    del model, v7
    profile_train(smi)

    # each row counts the launches of the path whose shape it times:
    # predict_batch for greedy_nms and head_scores, validate for
    # greedy_nms_eval (validate launches no head_scores: checked), the EMA
    # model's eval step after training for greedy_nms_train_eval (the eval
    # shape), the v7 run_detector_bench for greedy_nms_v7 and head_scores_v7,
    # the reference-order requests for head_scores_anchor_major
    rows["greedy_nms"]["launches"] = counts["greedy_nms"]
    rows["head_scores"]["launches"] = counts["head_scores"]
    rows["greedy_nms_eval"]["launches"] = eval_counts["greedy_nms"]
    rows["greedy_nms_train_eval"]["launches"] = train_counts["greedy_nms"]
    rows["greedy_nms_v7"]["launches"] = v7_counts["greedy_nms"]
    rows["head_scores_v7"]["launches"] = v7_counts["head_scores"]
    rows["head_scores_anchor_major"]["launches"] = ref_counts["head_scores"]
    rows["greedy_nms_serve"]["launches"] = serve_counts["greedy_nms"]
    rows["greedy_nms_fit"]["launches"] = fit_counts["greedy_nms"]
    rows["greedy_nms_fit_host"]["launches"] = fit_host_counts["greedy_nms"]
    rows["greedy_nms_ddp"]["launches"] = ddp_counts["greedy_nms"][0]
    rows["greedy_nms_ddp"]["launches_by_rank"] = ddp_counts["greedy_nms"]
    rows["head_scores_serve"]["launches"] = serve_counts["head_scores"]
    rows["greedy_nms_video"]["launches"] = video_counts["greedy_nms"]
    rows["head_scores_video"]["launches"] = video_counts["head_scores"]
    for name in ("greedy_nms", "head_scores"):
        by_rank = [c[name] for c in ddp_counts["serve"]]
        rows[f"{name}_mesh_serve"]["launches"] = by_rank[0]
        rows[f"{name}_mesh_serve"]["launches_by_rank"] = by_rank
        rows[f"{name}_spatial"]["launches"] = spatial_counts[name][0]
        rows[f"{name}_spatial"]["launches_by_rank"] = spatial_counts[name]
    seconds["profiles and kernel times"] = time.perf_counter() - t_start - sum(
        seconds.values())
    # a leg inside its phase, not counted again in the total
    seconds.update({f"demo: {leg} (inside demo)": s for leg, s in demo_legs.items()})
    print(json.dumps({"kernels": list(rows.values())}))
    print("seconds by phase: " + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

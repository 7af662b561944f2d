"""The port's hand-written kernels against their plain versions on a CUDA
card. Every test here skips on a host without CUDA; on the card run

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(--noconftest: the suite's conftest imports JAX, which this file does not
need.)
"""

import numpy as np
import pytest
import torch

from vision_kit_tpu_torch.ops.boxes import box_iou_pairwise
from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep, greedy_keep_reference
from vision_kit_tpu_torch.ops.head_scores import head_scores, head_scores_reference
from vision_kit_tpu_torch.utils.kernel_bench import head_maps, head_scores_agree, make_boxes
from vision_kit_tpu_torch.utils.serve_bench import samples


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b", [8, 128])
@pytest.mark.parametrize("k", [252, 512, 1024, 1280, 2048])
@pytest.mark.parametrize("case", ["random", "crowded", "invalid_tail", "all_invalid"])
def test_greedy_kernel_bit_equal_to_plain(cuda, b, k, case):
    boxes, valid = make_boxes(np.random.default_rng(k), b, k, case, device=cuda)
    before = greedy_keep.launches
    got = greedy_keep(boxes, valid, 0.45)
    assert greedy_keep.launches == before + 1
    assert torch.equal(got, greedy_keep_reference(boxes, valid, 0.45))


def test_greedy_kernel_bit_equal_at_the_threshold(cuda):
    # integer boxes on a small grid give exact IoU ties; thresholds at,
    # just below and just above those values test the kernel's IoU
    # comparison where it is tightest
    boxes, valid = make_boxes(np.random.default_rng(7), 8, 300, "grid", device=cuda)
    ious = torch.unique(box_iou_pairwise(boxes[:1], boxes[:1], eps=1e-9))
    for t in ious[(ious > 0.05) & (ious < 0.95)][::7].tolist():
        for thres in np.nextafter(np.float32(t), [np.float32(0), np.float32(1)]).tolist() + [t]:
            assert torch.equal(greedy_keep(boxes, valid, thres),
                               greedy_keep_reference(boxes, valid, thres)), thres


def test_greedy_kernel_rejects_bad_input(cuda):
    boxes = torch.zeros(2, 8, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        greedy_keep(boxes, torch.ones(2, 8, dtype=torch.bool, device=cuda), 0.5)
    shifted = torch.zeros(2 * 8 * 4 + 1, device=cuda)[1:].view(2, 8, 4)
    with pytest.raises(ValueError, match="16-byte"):
        greedy_keep(shifted, torch.ones(2, 8, dtype=torch.bool, device=cuda), 0.5)


def test_greedy_kernel_refuses_k_beyond_shared_memory(cuda):
    # two 64-row strips of the mask (512 W bytes each) must fit in a block
    k = 15000
    before = greedy_keep.launches
    with pytest.raises(ValueError, match="shared memory"):
        greedy_keep(torch.zeros(1, k, 4, device=cuda),
                    torch.ones(1, k, dtype=torch.bool, device=cuda), 0.5)
    assert greedy_keep.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch,grids", [
    (8, [(80, 80), (40, 40), (20, 20)]),     # the request path at 640
    (128, [(80, 80), (40, 40), (20, 20)]),   # the throughput path at 640
    (1, [(5, 5), (7, 3), (1, 1)]),           # ragged last tiles: 25, 21, 1 rows
    (3, [(16, 16), (8, 8), (4, 4)]),
])
def test_head_scores_kernel_matches_plain(cuda, dtype, masked, batch, grids):
    gen = torch.Generator(device=cuda).manual_seed(batch)
    raws = head_maps(gen, batch, dtype, grids)
    classes = (torch.arange(80, device=cuda) % 3 != 1) if masked else None
    before = head_scores.launches
    got = head_scores(raws, 0.25, classes)
    assert head_scores.launches == before + 1
    head_scores_agree(got, head_scores_reference(raws, 0.25, classes), 0.25)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch,grids", [
    (8, [(80, 80), (40, 40), (20, 20)]),     # the request path at 640
    (128, [(80, 80), (40, 40), (20, 20)]),   # the throughput path at 640
    (1, [(5, 5), (7, 3), (1, 1)]),           # ragged last tiles
])
def test_head_scores_kernel_anchor_major_matches_plain(cuda, dtype, masked, batch, grids):
    """A decode_order="reference" head's (B, na, ny, nx, no) views of the
    same maps: the kernel reads the native memory and writes the columns
    in (ia, iy, ix) order, as the plain version does on the views."""
    gen = torch.Generator(device=cuda).manual_seed(batch)
    raws = [r.permute(0, 3, 1, 2, 4) for r in head_maps(gen, batch, dtype, grids)]
    classes = (torch.arange(80, device=cuda) % 3 != 1) if masked else None
    before = head_scores.launches
    got = head_scores(raws, 0.25, classes, anchor_major=True)
    assert head_scores.launches == before + 1
    head_scores_agree(got, head_scores_reference(raws, 0.25, classes,
                                                 anchor_major=True), 0.25)


def test_head_scores_kernel_refuses_anchor_major_of_other_memory(cuda):
    raw = torch.zeros(1, 3, 4, 4, 85, device=cuda)
    before = head_scores.launches
    with pytest.raises(ValueError, match="permuted views"):
        head_scores([raw], 0.25, anchor_major=True)
    assert head_scores.launches == before


def test_head_scores_kernel_every_class_masked(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    raws = head_maps(gen, 2, torch.bfloat16, [(8, 8), (4, 4)])
    classes = torch.zeros(80, dtype=torch.bool, device=cuda)
    ks, kc = head_scores(raws, 0.0, classes)
    rs, rc = head_scores_reference(raws, 0.0, classes)
    assert torch.equal(kc, rc) and torch.equal(ks, rs)


def test_head_scores_kernel_rejects_relayout(cuda):
    raw = torch.zeros(1, 85, 3, 4, 4, device=cuda).permute(0, 3, 4, 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        head_scores([raw], 0.25)


def test_head_scores_kernel_rejects_misaligned_base(cuda):
    n = 2 * 4 * 4 * 255
    raw = torch.zeros(n + 1, device=cuda, dtype=torch.bfloat16)[1:]
    raw = raw.view(2, 4, 4, 3, 85)
    assert raw.is_contiguous() and raw.data_ptr() % 16
    before = head_scores.launches
    with pytest.raises(ValueError, match="16-byte"):
        head_scores([raw], 0.25)
    assert head_scores.launches == before


def test_eval_postprocess_kernel_equals_plain_keep(cuda, monkeypatch):
    """The eval protocol's postprocess at B=4 (K=2048 candidates of a
    crowded decoded map of v5s@640's shape) through the greedy-NMS kernel
    equals the same call on the plain keep."""
    from vision_kit_tpu_torch.ops import nms
    from vision_kit_tpu_torch.train.step import EVAL_POSTPROCESS

    gen = torch.Generator(device=cuda).manual_seed(11)
    b, n = 4, 25200
    cxcy = torch.rand(b, n, 2, generator=gen, device=cuda) * 640
    wh = 10 + torch.rand(b, n, 2, generator=gen, device=cuda) * 190
    conf = torch.rand(b, n, 81, generator=gen, device=cuda)
    preds = torch.cat([cxcy, wh, conf], dim=-1)
    before = greedy_keep.launches
    got = nms.postprocess(preds, **EVAL_POSTPROCESS)
    assert greedy_keep.launches == before + 1
    monkeypatch.setattr(nms, "greedy_keep", greedy_keep_reference)
    want = nms.postprocess(preds, **EVAL_POSTPROCESS)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert int(got[1].sum(1).min()) > 100


@pytest.mark.parametrize("shape,k", [((256, 80), 20), ((64, 2048), 300),
                                     ((4, 504000), 2048)])
def test_topk_stable_orders_ties_on_the_card(cuda, shape, k):
    """Both routes of topk_stable, and the choice between them, give a
    stable argsort's order of ties on the card as on the CPU, at the eval
    path's widths (80 classes, a 2048-candidate max_det cut, 504,000
    candidates)."""
    from vision_kit_tpu_torch.ops import nms

    rng = np.random.default_rng(3)
    x = (rng.integers(0, 8, shape) / 8).astype(np.float32)
    x[rng.random(shape) < 0.15] = nms.NEG_INF
    want = np.argsort(-x, axis=-1, kind="stable")[..., :k]
    xt = torch.from_numpy(x)
    for fn in (nms._topk_by_sort, nms._topk_by_int64, nms.topk_stable):
        np.testing.assert_array_equal(fn(xt.to(cuda), k)[1].cpu().numpy(), want)
        np.testing.assert_array_equal(fn(xt, k)[1].numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v7_deploy_predictor_kernels_equal_plain(cuda, dtype, monkeypatch):
    """A deploy v7 base folded from a calibrated training structure (as
    chip_smoke's v7 phase makes it), behind Predictor at 128: both
    structures' raw maps pass head_scores' layout check, each kernel
    launches once a request, and the detections equal those of the plain
    versions."""
    from vision_kit_tpu_torch.convert import deploy_state_dict
    from vision_kit_tpu_torch.models import YOLOV7
    from vision_kit_tpu_torch.models.architectures import init_weights
    from vision_kit_tpu_torch.ops import nms
    from vision_kit_tpu_torch.ops.head_scores import _check
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.utils.stream_bench import (
        calibrate_bn,
        calibrate_head,
        same_detections,
    )

    train = YOLOV7("base")
    init_weights(train, torch.Generator().manual_seed(0))
    train = train.to(cuda, memory_format=torch.channels_last).eval()
    calibrate_bn(train, 128, seed=2)
    calibrate_head(train, 128, seed=1)
    deploy = YOLOV7("base", deploy=True)
    deploy.load_state_dict(deploy_state_dict(train.state_dict()), strict=True)
    deploy = deploy.to(cuda, dtype, memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 255, (2, 128, 128, 3), dtype=np.uint8)).to(cuda)
    with torch.no_grad():
        for model in (train, deploy):
            _check(model(x, decode=False), None)

    pred = Predictor(deploy, img_size=128, device=cuda)
    frames = rng.integers(0, 255, (2, 96, 160, 3), dtype=np.uint8)
    before = greedy_keep.launches, head_scores.launches
    got, _ = pred.predict_batch(frames)
    assert (greedy_keep.launches, head_scores.launches) == (before[0] + 1, before[1] + 1)
    monkeypatch.setattr(nms, "head_scores", head_scores_reference)
    monkeypatch.setattr(nms, "greedy_keep", greedy_keep_reference)
    want, _ = pred.predict_batch(frames)
    assert sum(len(w) for w in want) > 20
    for w, g in zip(want, got):
        assert same_detections(w, g), (w, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_subclass_eval_bit_equal_on_the_card(cuda, dtype):
    """The port's BatchNorm2d in eval mode is nn.BatchNorm2d's forward: the
    same cuDNN call, bit-equal, so the eval and serving paths do not move."""
    from torch import nn

    from vision_kit_tpu_torch.models.layers import BatchNorm2d

    gen = torch.Generator().manual_seed(4)
    bn, ref = BatchNorm2d(64, eps=1e-3, momentum=0.03), nn.BatchNorm2d(64, eps=1e-3, momentum=0.03)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(64, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(64, generator=gen))
        bn.running_mean.copy_(torch.randn(64, generator=gen))
        bn.running_var.copy_(torch.rand(64, generator=gen) + 0.5)
    ref.load_state_dict(bn.state_dict())
    x = torch.randn(8, 64, 40, 40, generator=gen).to(cuda, dtype,
                                                     memory_format=torch.channels_last)
    bn, ref = bn.to(cuda, dtype).eval(), ref.to(cuda, dtype).eval()
    with torch.no_grad():
        assert torch.equal(bn(x), ref(x))


def _config(name: str, **model):
    import os

    from vision_kit_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", name))
    for k, v in model.items():
        setattr(cfg.model, k, v)
    return cfg


def test_train_step_card_matches_cpu(cuda):
    """One f32 step of v5n@128, B=2, from the same state on the card and
    on the CPU: the losses to 1e-4 relative, the gradient norm to 1e-3, and
    every parameter, statistic, momentum buffer and EMA tensor to 1e-4 of
    its largest magnitude plus 2e-3 of the step's largest change to it
    (stream_bench.train_step_card_vs_cpu)."""
    from vision_kit_tpu_torch.utils.stream_bench import train_step_card_vs_cpu

    cfg = _config("yolov5.yaml", version="n", num_classes=80, input_size=[128, 128])
    bad, _ = train_step_card_vs_cpu(cfg)
    assert bad == []


def test_ota_loss_card_matches_cpu(cuda):
    """YoloLossOTA on the same raw maps of v7 base@128 (training
    structure, training forward on the CPU) on the card and on the CPU: the
    assignment equal (fg mask and matched label), the loss and its parts
    to 1e-5 relative, each map's gradient to 1e-4 of its largest element
    (stream_bench.ota_card_vs_cpu)."""
    from vision_kit_tpu_torch.utils.stream_bench import ota_card_vs_cpu

    cfg = _config("yolov7.yaml", version="base", num_classes=80, deploy=False,
                  input_size=[128, 128])
    bad, errors = ota_card_vs_cpu(cfg)
    assert bad == [] and errors["fg"] > 0


def test_letterbox_u8_card_equals_cpu(cuda):
    from vision_kit_tpu_torch.ops.letterbox import letterbox_u8

    rng = np.random.default_rng(5)
    for hw in ((720, 1280), (333, 517), (1280, 1280), (100, 100), (1000, 3)):
        img = torch.from_numpy(rng.integers(0, 256, (*hw, 3), np.uint8))
        for dst in (64, 640):
            if min(hw) * dst < max(hw):
                continue   # a resize to zero width or height
            got, g = letterbox_u8(img.to(cuda), dst)
            want, w = letterbox_u8(img, dst)
            assert g == w
            assert torch.equal(got.cpu(), want)


def test_nvjpeg_against_the_plain_decoder(cuda):
    """Each committed sample decoded on the card by its route (nvJPEG for a
    baseline or complete progressive JPEG, the host decoder uploaded for the
    rest) against decode_image: refusals alike, shapes equal (EXIF
    applied), the host routes bit-equal, nvJPEG within NVJPEG_TOLERANCE."""
    from vision_kit_tpu_torch.data import decode as dec

    for name, meta, data in samples():
        got, want = dec.decode_to(data, cuda), dec.decode_image(data)
        if meta["shape"] is None:
            assert got is None and want is None, name
            continue
        assert tuple(got.shape) == want.shape == (*meta["shape"], 3), name
        agree = dec.pixel_agreement(got, want)
        if dec.decode_route(data, cuda).startswith("nvjpeg"):
            assert dec.within_nvjpeg_tolerance(agree), (name, agree)
        else:
            assert agree["max_abs"] == 0, name


def test_c_walk_equals_scans_short(cuda):
    """The host C walk of csrc/jpeg_walk.cu counts what scans_short counts
    on every JPEG sample, its cut inside the last scan and cuts at restart
    markers; the short ones route to "host_cut", the whole ones not."""
    from vision_kit_tpu_torch.utils.serve_bench import walk_cases, walk_disagreements

    cases = walk_cases()
    assert len(cases) > 30
    assert walk_disagreements(cases, cuda) == []


def test_cut_jpegs_decode_on_the_host(cuda):
    """A baseline and a progressive sample cut inside their last scan decode
    by "host_cut", bit-equal to decode_image, and never reach nvJPEG."""
    from vision_kit_tpu_torch.data import decode as dec
    from vision_kit_tpu_torch.utils.serve_bench import cut_inside_last_scan, sample_bytes

    for kind in ("jpeg_720p", "jpeg_progressive"):
        cut = cut_inside_last_scan(sample_bytes(kind)[0])
        calls = dec.decode_jpeg_cuda.calls
        assert dec.decode_route(cut, cuda) == "host_cut"
        got = dec.decode_to(cut, cuda)
        assert dec.decode_jpeg_cuda.calls == calls
        assert torch.equal(got.cpu(), torch.from_numpy(dec.decode_image(cut)))


def test_nvjpeg_decodes_after_a_corrupt_jpeg(cuda):
    from vision_kit_tpu_torch.data import decode as dec

    data = next(d for _, m, d in samples() if m["kind"] == "jpeg_720p")
    first = dec.decode_to(data, cuda)
    sof = data.index(b"\xff\xc0")
    # the first component names quantization table 3, which no DQT defines:
    # the header check and the C walk pass it, nvJPEG refuses it
    corrupt = data[:sof + 12] + bytes([3]) + data[sof + 13:]
    calls = dec.decode_jpeg_cuda.calls
    assert dec.decode_to(corrupt, cuda) is None
    assert dec.decode_jpeg_cuda.calls == calls + 1
    again = dec.decode_to(data, cuda)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_jpegs_without_huffman_tables_through_nvjpeg(cuda):
    """The DHT-less 720p frame and the optimised-slot-0 sample: route
    "nvjpeg", the C walk and scans_short [0], nvJPEG (the standard tables
    spliced in front of it) within NVJPEG_TOLERANCE of decode_image, one
    nvJPEG decode each; the same frame's bytes in a Motion-JPEG AVI play
    to the last frame in VideoReader on the card."""
    from vision_kit_tpu_torch.data import decode as dec
    from vision_kit_tpu_torch.utils.serve_bench import sample_bytes

    for kind in ("jpeg_no_dht", "jpeg_std_slot1"):
        data = sample_bytes(kind)[0]
        assert dec.decode_route(data, cuda) == "nvjpeg", kind
        assert dec.walk_scans_short(data) == dec.scans_short(data) == [0], kind
        calls = dec.decode_jpeg_cuda.calls
        got = dec.decode_to(data, cuda)
        assert dec.decode_jpeg_cuda.calls == calls + 1
        agree = dec.pixel_agreement(got, dec.decode_image(data))
        assert dec.within_nvjpeg_tolerance(agree), (kind, agree)


def test_c_walk_on_jpegs_without_huffman_tables(cuda):
    """The C walk on the DHT-less and optimised-slot-0 samples, on each
    without any DHT or without slot 1, on them cut inside their scan, and
    on a progressive file without its tables (both walks refuse it): equal
    to scans_short."""
    from vision_kit_tpu_torch.data import decode as dec
    from vision_kit_tpu_torch.utils.serve_bench import (cut_inside_last_scan, sample_bytes,
                                                        walk_disagreements)

    from chip_smoke import without_huffman_tables

    cases = []
    for kind in ("jpeg_no_dht", "jpeg_std_slot1", "jpeg_720p", "jpeg_restart"):
        data = sample_bytes(kind)[0]
        bare = without_huffman_tables(data)
        cases += [(kind, data), (kind + " bare", bare),
                  (kind + " bare cut", cut_inside_last_scan(bare))]
    assert walk_disagreements(cases, cuda) == []
    bare = without_huffman_tables(sample_bytes("jpeg_progressive")[0])
    with pytest.raises(dec.JpegError):
        dec.walk_scans_short(bare)
    with pytest.raises(dec.JpegError):
        dec.scans_short(bare)


class _CrashingLoader:
    """A TrainLoader whose iterator raises after `after` batches."""

    def __init__(self, loader, after: int):
        self.loader, self.after = loader, after

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i == self.after:
                raise RuntimeError("crash injected")
            yield batch


def resume_after_other_fits(data_dir: str, out: str) -> dict:
    """In this process: a default-mode fit, then a deterministic fit that
    crashes after step 3 and its resume from ckpts/last, then an
    uninterrupted deterministic fit; the state tensors in which the resumed
    run differs from the uninterrupted one. v5n@320 on write_dataset's
    files, 2 epochs at batch 8. Needs CUBLAS_WORKSPACE_CONFIG=:4096:8 set
    before CUDA starts."""
    import json
    import os

    from vision_kit_tpu_torch.train.trainer import Trainer
    from vision_kit_tpu_torch.utils import stream_bench as sb
    from vision_kit_tpu_torch.utils.general import update_loss_cfg

    def trainer(name: str, deterministic: bool):
        cfg = _config("yolov5_tpu.yaml", version="n", num_classes=2, input_size=[320, 320],
                      weight="")
        cfg.data.update(data_dir=data_dir, output_dir=os.path.join(out, name),
                        train_path="train", val_path="valid", test_path="valid",
                        batch_size=8, max_epochs=2, class_labels=["a", "b"])
        cfg.testing.val_interval = 1
        return Trainer(update_loss_cfg(cfg), use_tensorboard=False, seed=0, device="cuda",
                       deterministic=deterministic)

    first = trainer("default", False)
    first.fit()
    first.train_loader.close()
    del first
    crashed = trainer("crash", True)
    crashed.train_loader = _CrashingLoader(crashed.train_loader, 3)
    try:
        crashed.fit()
    except RuntimeError as e:
        if "injected" not in str(e):
            raise
    crashed.train_loader.close()
    last = os.path.join(crashed.output_dir, "ckpts", "last")
    with open(last + ".meta.json") as f:
        saved = json.load(f)["step"]
    del crashed
    resumed = trainer("crash", True)
    resumed.fit(resume=last)
    resumed.train_loader.close()
    ref = trainer("ref", True)
    ref.fit()
    ref.train_loader.close()
    want, got = sb.train_state_tensors(ref.state), sb.train_state_tensors(resumed.state)
    return {"saved_step": saved, "step": resumed.state.step, "ref_step": ref.state.step,
            "differ": [f"{p} {k}" for p in sb.STATE_PARTS for k in want[p]
                       if not torch.equal(want[p][k], got[p][k])]}


def test_deterministic_resume_after_other_fits(cuda, tmp_path):
    """ROADMAP Queue 3 item 2: a deterministic resume made after a
    default-mode fit in the same process (a child with
    CUBLAS_WORKSPACE_CONFIG set before CUDA) ends bit-identical to an
    uninterrupted deterministic fit."""
    import json
    import os
    import subprocess
    import sys

    from vision_kit_tpu_torch.utils import loader_bench as lb

    lb.write_dataset(str(tmp_path / "ds"), n_train=32, n_val=8)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join([repo, os.path.dirname(os.path.abspath(__file__))]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--resume-after-fits",
                           str(tmp_path / "ds"), str(tmp_path / "out")], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    print("deterministic resume after a default fit: " + json.dumps(res))
    assert 0 < res["saved_step"] < res["step"] == res["ref_step"], res
    assert res["differ"] == [], res


def test_card_loaders_agree_with_the_plain_ones(cuda, tmp_path):
    """write_dataset's files (JPEG samples and PNG scenes) through a card
    dataset and a CPU one: TrainLoader params, tile_hw and targets equal,
    PNG tiles bit-equal and JPEG tiles within NVJPEG_TOLERANCE in their
    valid regions, and the same for ValLoader's images and infos
    (loader_bench.loader_disagreements)."""
    from vision_kit_tpu_torch.data.datasets import YOLODataset
    from vision_kit_tpu_torch.utils import loader_bench as lb

    made = lb.write_dataset(str(tmp_path), n_train=16, n_val=8)
    split = str(tmp_path / "train")
    card = YOLODataset(split, img_size=320, device=cuda)
    plain = YOLODataset(split, img_size=320, device="cpu", cache_images="ram")
    assert len(card) == 16 + len(made["restored"]) and card.decoder == "nvjpeg"
    assert lb.restore_disagreements(str(tmp_path), made["restored"]) == []
    mixup = {"enable_mixup": True, "mixup_prob": 1.0}
    assert lb.loader_disagreements(card, plain, batch=4, size=320, aug=mixup) == []


def test_two_step_fit_on_the_card(cuda, tmp_path):
    """Trainer.fit of v5n@320 in bf16 on the card, one epoch of 2 steps
    with the RAM cache in device memory, then test(): the greedy-NMS kernel
    launched once per validation batch, the checkpoint and best weights
    written."""
    from vision_kit_tpu_torch.ops.greedy_nms import greedy_keep
    from vision_kit_tpu_torch.train.trainer import Trainer
    from vision_kit_tpu_torch.utils import loader_bench as lb

    lb.write_dataset(str(tmp_path / "ds"), n_train=8, n_val=8)
    cfg = _config("yolov5_tpu.yaml", version="n", num_classes=2, input_size=[320, 320],
                  weight="")
    cfg.data.update(data_dir=str(tmp_path / "ds"), output_dir=str(tmp_path / "out"),
                    train_path="train", val_path="valid", test_path="valid",
                    batch_size=4, max_epochs=1, class_labels=["a", "b"])
    tr = Trainer(cfg, use_tensorboard=False, seed=0, device=cuda)
    assert tr.train_loader.device.type == "cuda"
    before = greedy_keep.launches
    tr.fit()
    assert greedy_keep.launches == before + len(tr.val_loader)
    result = tr.test()
    assert np.isfinite(result["map50"])
    assert (tmp_path / "out" / "ckpts" / "last" / "_METADATA").is_file()
    assert list((tmp_path / "out" / "weights").glob("best-map50_*.msgpack"))


def test_host_route_ops_card_equal_cpu(cuda):
    """Each op of the host-augmentation route (ops/imgproc.py: the warp under
    rotation, shear and translation, HSV at three gain draws, blur, median,
    gray, Lab, CLAHE, the pad) on the card equals its CPU result bit for bit
    on a seeded 640 x 640 and 1280 x 1280 image
    (loader_bench.imgproc_disagreements)."""
    from vision_kit_tpu_torch.utils import loader_bench as lb

    assert lb.imgproc_disagreements(cuda) == []


def test_host_route_loader_card_equal_cpu(cuda, tmp_path):
    """The host-augmentation TrainLoader with mixup, rotation and shear over
    PNG scenes on the card (num_workers 0: every op on the card) against the
    same files on the CPU: images and targets bit-equal."""
    from vision_kit_tpu_torch.data.datasets import YOLODataset
    from vision_kit_tpu_torch.utils import loader_bench as lb

    lb.write_dataset(str(tmp_path), n_train=16, n_val=8, png_only=True)
    split = str(tmp_path / "train" / "images")
    card = YOLODataset(split, img_size=320, device=cuda)
    plain = YOLODataset(split, img_size=320, device="cpu")
    aug = dict(lb.HOST_AUG, enable_mixup=True)
    assert lb.host_loader_disagreements(card, plain, batch=4, size=320, aug=aug) == []


def test_world1_nccl_step_matches_the_step_without_a_mesh(cuda, monkeypatch):
    """A world of one over NCCL (parallel/distributed.py:init_distributed at
    a free localhost port): one f32 v5n@128 step of b4 under the mesh
    equals the same step without it, from the same seeded state and batch
    (stream_bench.mesh_step_disagreements: state within 1e-4 of a tensor
    plus 2e-3 of its change, losses 1e-4). Two ranks sharing the card over
    gloo run in chip_smoke.py's ddp phase."""
    import socket

    import torch.distributed as dist

    from vision_kit_tpu_torch.parallel import init_distributed, make_mesh
    from vision_kit_tpu_torch.utils.stream_bench import mesh_step_disagreements

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        cfg = _config("yolov5.yaml", version="n", num_classes=80, input_size=[128, 128])
        bad, metrics = mesh_step_disagreements(make_mesh(), cfg, batch=4)
        assert bad == [], bad
        assert metrics["mesh"]["loss"] > 0
    finally:
        dist.destroy_process_group()


def _calibrated_v5n_file(path: str, size: int) -> str:
    """A seeded v5n (80 classes) with its head calibrated to unit logit
    spread on a probe batch (crowded detections), saved as a state_dict."""
    from vision_kit_tpu_torch.models import YOLOV5
    from vision_kit_tpu_torch.utils.stream_bench import calibrate_head

    torch.manual_seed(0)
    model = YOLOV5("n", num_classes=80).eval()
    calibrate_head(model, size, seed=1)
    torch.save(model.state_dict(), path)
    return path


def test_mesh_predictor_on_two_ranks_sharing_the_card(cuda, tmp_path):
    """Predictor(mesh=...) on two gloo ranks, both on the card: a batch of 4
    splits 2 a rank, each rank's rows equal to the same rows run alone on
    the card bit for bit, both ranks holding the whole batch; a batch of 3
    runs whole on each rank."""
    from torch_dist_lib import run_ranks

    path = _calibrated_v5n_file(str(tmp_path / "v5n.pt"), 320)
    batches = {"divides": (11, 4), "does_not_divide": (12, 3)}
    r0, r1 = run_ranks(2, "torch_dist_lib:predictor_worker",
                       {"state_path": path, "size": 320, "batches": batches,
                        "kw": {"max_cand": 512, "max_det": 100}, "device": "cuda"})
    for r in (r0, r1):
        for name, (_, n) in batches.items():
            got = r[name]["predict_batch"]
            assert len(got) == n and sum(len(d) for d in got) > 0
            for a, b in zip(got, r0[name]["predict_batch"]):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(got, r[name]["run"]):
                np.testing.assert_array_equal(a, b)
        for i, row in enumerate(r["divides"]["rows"]):
            np.testing.assert_array_equal(r["divides"]["alone"][i],
                                          r["divides"]["predict_batch"][row])
    assert r0["divides"]["rows"] == [0, 1] and r1["divides"]["rows"] == [2, 3]


def test_spatial_predictor_on_two_ranks_sharing_the_card(cuda, tmp_path):
    """Predictor(spatial=True) on a 1x2 mesh of two gloo ranks, both on the
    card, in f32: each rank's detections equal to one process's on the card
    (score 1e-4, box 1e-2 px), each kernel launched once a rank a request on
    the gathered maps."""
    from torch_dist_lib import run_ranks, serving_frames
    from vision_kit_tpu_torch.models import YOLOV5
    from vision_kit_tpu_torch.predictor import Predictor
    from vision_kit_tpu_torch.utils.stream_bench import same_detections

    path = _calibrated_v5n_file(str(tmp_path / "v5n.pt"), 320)
    kw = {"max_cand": 512, "max_det": 100}
    results = run_ranks(2, "torch_dist_lib:spatial_predictor_worker",
                        {"state_path": path, "size": 320, "hw": [360, 640], "n": 2,
                         "kw": kw, "device": "cuda"}, n_model=2)
    model = YOLOV5("n", num_classes=80)
    model.load_state_dict(torch.load(path, weights_only=True))
    one = Predictor(model, img_size=320, device="cuda", **kw)
    single = one(serving_frames(7, 1, (360, 640))[0])[0]
    batch = one.predict_batch(serving_frames(8, 2, (360, 640)))[0]
    for r in results:
        assert r["launches"] == [1, 1]
        assert len(single) > 0 and same_detections(single, r["single"], 1e-4, 1e-2)
        for w, g, run in zip(batch, r["batch"], r["run"]):
            assert same_detections(w, g, 1e-4, 1e-2)
            np.testing.assert_array_equal(g, run)


def test_msgpack_export_leg_served_on_the_card(cuda, tmp_path):
    """run_export's Flax msgpack of a model on the card, loaded back by
    load_predictor_from_config on the card: the same detections, bit for
    bit, as the in-memory model."""
    from vision_kit_tpu_torch.export import run_export
    from vision_kit_tpu_torch.models import build_model
    from vision_kit_tpu_torch.predictor import Predictor, load_predictor_from_config
    from vision_kit_tpu_torch.utils.stream_bench import calibrate_head

    cfg = _config("yolov5.yaml", version="n", num_classes=80, input_size=[320, 320])
    model = build_model(cfg, device=cuda, seed=0)
    calibrate_head(model, 320, seed=1)
    res = run_export(cfg, model, str(tmp_path), onnx=False, torchscript=False)
    assert res.checks["msgpack"] == 0.0
    frames = np.random.default_rng(3).integers(0, 255, (4, 360, 640, 3), dtype=np.uint8)
    want, _ = Predictor(model, img_size=320, device=cuda).predict_batch(frames)
    loaded = load_predictor_from_config(cfg, weights=res.artifacts["msgpack"], device=cuda)
    got, _ = loaded.predict_batch(frames)
    assert sum(len(w) for w in want) > 0
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_plain_decoder_batches_do_not_depend_on_workers(cuda, tmp_path):
    """decoder "plain" on the card: the host route's TrainLoader batches
    (rotation, shear, mosaic, mixup) are the same bytes with 0 workers
    (every op on the card) and with 8 (decode and augmentation on the host)
    (loader_bench.workers_disagreements); decoder "nvjpeg" with workers
    raises."""
    from vision_kit_tpu_torch.data.datasets import YOLODataset
    from vision_kit_tpu_torch.data.loader import TrainLoader
    from vision_kit_tpu_torch.utils import loader_bench as lb

    lb.write_dataset(str(tmp_path), n_train=16, n_val=8)
    split = str(tmp_path / "train")
    plain = YOLODataset(split, img_size=320, device=cuda, decoder="plain")
    assert plain.decoder == "plain"
    aug = dict(lb.HOST_AUG, enable_mixup=True)
    assert lb.workers_disagreements(plain, 4, 320, workers=8, aug=aug) == []
    nvjpeg = YOLODataset(split, img_size=320, device=cuda, decoder="nvjpeg")
    with pytest.raises(ValueError, match="'nvjpeg'"):
        TrainLoader(nvjpeg, 4, img_size=320, num_workers=2)


def test_mpeg4_host_decoder_equals_plain(cuda):
    """csrc/mpeg4_decode.cu (nvcc-built) against the plain decoder on the
    committed mp4v clips: the small AVI whole and the 720p clip's first GOP
    and next I-VOP bit-equal, every frame's RGB on the card at cv2's
    sha256 (video_bench.mpeg4_disagreements)."""
    from vision_kit_tpu_torch.utils import video_bench as vb

    bad, _ = vb.mpeg4_disagreements({vb.SMALL_CLIP: 10, vb.HD_CLIP: 9}, cuda)
    assert bad == []


def test_mpeg4_host_decoder_on_matroska_and_xvid_clips(cuda):
    """The committed 720p Matroska clip (the first GOP and the next I-VOP
    bit-equal to the plain decoder) and the XviD-tagged AVI (whole): every
    frame at cv2's sha256, the XviD one through the XviD IDCT."""
    from vision_kit_tpu_torch.utils import video_bench as vb

    bad, _ = vb.mpeg4_disagreements({vb.HD_MKV: 9, vb.XVID_AVI: 6}, cuda)
    assert bad == []


def test_vp8_host_decoder_equals_plain(cuda):
    """csrc/vp8_decode.cu (nvcc-built) on the committed VP8 clips: every
    frame's RGB on the card at cv2's sha256, the small clip's planes
    bit-equal to the plain decoder's (video_bench.vp8_disagreements)."""
    from vision_kit_tpu_torch.utils import video_bench as vb

    bad, ms = vb.vp8_disagreements(cuda, reps=1)
    assert bad == [] and ms["cpp"]["key"] > 0


def test_vp9_host_decoder_equals_plain(cuda):
    """csrc/vp9_decode.cu (nvcc-built) on the committed VP9 clips: every
    frame's RGB on the card at cv2's sha256, the small clip's planes
    bit-equal to the plain decoder's (video_bench.vp9_disagreements)."""
    from vision_kit_tpu_torch.utils import video_bench as vb

    bad, ms = vb.vp9_disagreements(cuda, reps=1)
    assert bad == [] and ms["cpp"]["key"] > 0


def test_tag_fixtures_on_the_card(cuda):
    """data/video_samples/tags/ through VideoReader on the card, threaded
    and unthreaded: cv2's count, fps and frames, the card's frames equal
    to the plain CPU read (nvJPEG's within its tolerance), the Motion JPEG
    2000 frames by the nvcc-built twin's video mode, none counted as a
    still image (video_bench.tag_disagreements)."""
    from vision_kit_tpu_torch.utils import video_bench as vb

    bad, info = vb.tag_disagreements(cuda)
    assert bad == [] and info[vb.MJ2_MOV]["route"] == "host_cpp", (bad, info)


def test_mpeg4_host_decoder_on_xvid_streams(cuda, tmp_path):
    """csrc/mpeg4_decode.cu (nvcc-built) against the plain decoder on random
    streams libavcodec takes as XviD's (an XVID or XVIX tag, XviD0050 or
    XviD0002 user data) and not (Lavc user data), in an AVI and in a
    Matroska VFW track, with video packets and with DCs past 2047: the
    planes and the identification equal."""
    from torch_mkv_samples import bitmapinfoheader, build
    from torch_mpeg4_samples import random_stream
    from vision_kit_tpu_torch.data import mpeg4
    from vision_kit_tpu_torch.utils.avi import AviWriter
    from vision_kit_tpu_torch.utils.mkv import VFW
    from vision_kit_tpu_torch.utils.readers import open_movie

    for tag, user in ((b"XVID", b""), (b"XVIX", b""), (b"FMP4", b"XviD0050"),
                      (b"FMP4", b"XviD0002"), (b"XVID", b"Lavc62.0.0")):
        for seed, kw in ((1, {"resync": True}), (2, {"bright": True})):
            headers, vops = random_stream(seed, 150, 100, 6, user_data=user, **kw)
            avi, mkv = str(tmp_path / "s.avi"), str(tmp_path / "s.mkv")
            with AviWriter(avi, 30.0, tag) as w:
                for i, (vop, key) in enumerate(vops):
                    w.write((headers if i == 0 else b"") + vop, 150, 100, key)
            build(mkv, [v for v, _ in vops], [k for _, k in vops], 150, 100, codec_id=VFW,
                  private=bitmapinfoheader(150, 100, tag, headers))
            for path in (avi, mkv):
                movie = open_movie(path)
                decs = [mpeg4.Mpeg4Decoder(movie.config or None, d, codec_tag=movie.tag)
                        for d in ("cuda", "cpu")]
                with open(path, "rb") as f:
                    for i in range(len(movie.frames)):
                        data = movie.read_frame(f, i)
                        got, want = (d.decode(data) for d in decs)
                        assert all(np.array_equal(a, b) for a, b in zip(got, want)), \
                            (tag, user, seed, path, i)
                assert decs[0].identity() == decs[1].identity(), (tag, user)
                decs[0].close()


def test_video_reader_nvjpeg_on_a_matroska_clip(cuda):
    """VideoReader on the committed V_MJPEG Matroska clip: plain frames
    equal to decode_image, nvJPEG's within NVJPEG_TOLERANCE, threaded =
    unthreaded, also behind queued work on the card
    (video_bench.reader_disagreements)."""
    import os

    from vision_kit_tpu_torch.utils import video_bench as vb

    path = os.path.join(vb.VIDEO_SAMPLES, vb.MJPEG_MKV)
    assert vb.reader_disagreements(path, vb.movie_frames(path), 30.0, cuda) == []


def test_video_reader_nvjpeg_against_plain(cuda, tmp_path):
    """VideoReader on a Motion-JPEG clip of the 720x1280 samples: the plain
    decoder's frames on the card bit-equal to decode_image, nvJPEG's within
    decode.NVJPEG_TOLERANCE of them, threaded = unthreaded, also behind
    queued work on the card (video_bench.reader_disagreements)."""
    from vision_kit_tpu_torch.utils import video_bench as vb

    path = str(tmp_path / "clip.avi")
    jpegs = vb.write_sample_clip(path, n_frames=6, fps=30.0)
    assert vb.reader_disagreements(path, jpegs, 30.0, cuda) == []


def test_fast_decode_items_card_equal_cpu(cuda, tmp_path):
    """YOLODataset(fast_decode=True) on the card and on the CPU: the same
    items bit for bit at 640, 320 and 160, where the 720x1280 samples
    reduce at 1/2, 1/4 and 1/8 (video_bench.fast_decode_disagreements)."""
    from vision_kit_tpu_torch.utils import loader_bench as lb
    from vision_kit_tpu_torch.utils import video_bench as vb

    lb.write_dataset(str(tmp_path), n_train=32, n_val=2)   # 24-28: the progressive files
    bad, reduced, files = vb.fast_decode_disagreements(
        str(tmp_path / "train"), (640, 320, 160), range(24))
    assert bad == [] and all(n > 0 for n in reduced.values()), (bad, reduced)
    assert any("progressive" in f for f in files), files


if __name__ == "__main__":
    import json
    import sys

    if len(sys.argv) == 4 and sys.argv[1] == "--resume-after-fits":
        print(json.dumps(resume_after_other_fits(sys.argv[2], sys.argv[3])), flush=True)

"""The eval step: forward with decode, then the eval-protocol postprocess,
on one device.

Counterpart of vision_kit_tpu/train/step.py:make_eval_step (without a mesh
or spatial partitioning). The training step comes with the training slice.
"""

from __future__ import annotations

import torch

from vision_kit_tpu_torch.ops.nms import postprocess

# the eval protocol: per-anchor top-20 class truncation gives the same mAP
# as the full N*nc expansion for any model whose anchors contribute <= 20
# classes to the global top-2048; set multi_label_top to 0 for the exact
# expansion
EVAL_POSTPROCESS = dict(conf_thres=0.001, iou_thres=0.6, multi_label=True,
                        max_det=300, max_cand=2048, multi_label_top=20)


def make_eval_step(model, postprocess_kwargs: dict | None = None):
    """Eval step over `model`, which is put in eval mode.

    The JAX step evaluates the EMA weights of its TrainState by default;
    the port has no TrainState or EMA yet, so this step evaluates the model
    it is given (the EMA copy, once training is ported).

    Returns eval_step(imgs): imgs (B, H, W, 3) uint8, a numpy array or a
    tensor on any device, goes straight into the model (the stem scales
    it), and eval_step returns (dets (B, max_det, 6), valid (B, max_det))
    on the model's device without synchronising.
    """
    kwargs = {**EVAL_POSTPROCESS, **(postprocess_kwargs or {})}
    model.eval()
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def eval_step(imgs):
        decoded, _ = model(torch.as_tensor(imgs, device=dev))
        return postprocess(decoded, **kwargs)

    return eval_step

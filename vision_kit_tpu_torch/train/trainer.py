"""Validation and test loops: the metric part of
vision_kit_tpu/train/trainer.py:Trainer.validate and Trainer.test.

Batches are in ValLoader's format: {"image": (B, S, S, 3) uint8,
"targets": (B, M, 5), "info": [(h0, w0, ratio, pad, img_id)], "count"}.
The Trainer class, its sample grids, loggers and tables come with the
training slice.
"""

from __future__ import annotations


def validate(eval_step, batches, evaluator, collect_coco: bool = False) -> dict:
    """Reset `evaluator`, run `eval_step` on every batch and accumulate its
    detections, then summarize.

    collect_coco: also accumulate the COCO-protocol metric set (float64
    copies of every batch); only `test` reads it.
    """
    evaluator.reset(collect_coco=collect_coco)
    for batch in batches:
        dets, valid = eval_step(batch["image"])
        evaluator.update(dets.cpu().numpy(), valid.cpu().numpy(),
                         batch["targets"], batch["info"], batch["count"])
    return evaluator.summarize()


def test(eval_step, batches, evaluator) -> dict:
    """validate with the COCO-protocol metric set under result["coco"]."""
    result = validate(eval_step, batches, evaluator, collect_coco=True)
    result["coco"] = evaluator.summarize_coco()
    return result

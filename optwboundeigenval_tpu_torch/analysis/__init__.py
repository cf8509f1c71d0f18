"""Evaluation beyond the training cascade (counterpart of
``optwboundeigenval_tpu/analysis/``)."""

"""Model-interpretation suite: LIME + KernelSHAP for tabular/vector/image/text.

Reference: core explainers/ (~1.9k LoC, LocalExplainer.scala:16 family) and
legacy lime/ (LIME.scala:333, Superpixel.scala:148-334).  Counterpart of the
JAX package's `explainers/`: one batched model transform for ALL rows'
perturbation samples, then every LIME row's weighted lasso / WLS solved in
one batched call on the card (regression.py); KernelSHAP solves on the host
in f64.
"""
from .base import KernelSHAPBase, LIMEBase, LocalExplainer
from .image import ImageLIME, ImageSHAP
from .regression import (
    batch_lasso,
    batch_weighted_least_squares,
    lasso,
    weighted_least_squares,
)
from .superpixel import SuperpixelTransformer, masked_image, slic_segments
from .tabular import TabularLIME, TabularSHAP, VectorLIME, VectorSHAP
from .text import TextLIME, TextSHAP

__all__ = [
    "LocalExplainer",
    "LIMEBase",
    "KernelSHAPBase",
    "TabularLIME",
    "TabularSHAP",
    "VectorLIME",
    "VectorSHAP",
    "ImageLIME",
    "ImageSHAP",
    "TextLIME",
    "TextSHAP",
    "SuperpixelTransformer",
    "slic_segments",
    "masked_image",
    "weighted_least_squares",
    "lasso",
    "batch_weighted_least_squares",
    "batch_lasso",
]

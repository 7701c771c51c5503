"""Binding autogenerator (reference: core codegen/, L7)."""
from .generate import camel, generate_r_wrappers, generate_tests, generate_wrappers

__all__ = ["generate_wrappers", "generate_tests", "generate_r_wrappers",
           "camel"]

"""Interval eigensolvers: FEAST (``eig.feast``) and its cached contour
pipeline (``eig.pipeline``), imported by path as in the JAX package."""

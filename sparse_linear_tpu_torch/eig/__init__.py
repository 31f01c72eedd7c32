"""Eigensolvers: FEAST (``eig.feast``) and its cached contour pipeline
(``eig.pipeline``), and the Chebyshev-filtered subspace iteration
(``eig.chebyshev``), imported by path as in the JAX package."""

"""Functional solver cores (CG, the Tikhonov quadratic engine, ADMM and
primal-dual), and the solver classes over them (``base``, ``wrappers``)."""

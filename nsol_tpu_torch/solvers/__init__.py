"""Functional solver cores: CG, the Tikhonov quadratic engine, ADMM and
primal-dual."""

"""Condensed consensus QP assembly and the box-constrained IPM."""

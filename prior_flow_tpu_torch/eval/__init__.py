"""Evaluation: the spherical metrics and the validators."""

"""Evaluation core: environment, groups, oracle."""

"""Optimizers, learning-rate schedules and the parameter updater."""

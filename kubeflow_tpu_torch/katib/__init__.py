"""The port's Katib client: the worker's trial-observation reporter."""

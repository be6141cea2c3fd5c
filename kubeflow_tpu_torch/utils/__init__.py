"""Helpers: ``tbevents`` (TensorBoard event files, dependency-free) and
``chips`` (the card's spec sheet and the ResNet-50 FLOP model)."""

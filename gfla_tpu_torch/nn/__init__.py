"""Layers and blocks of the port (NCHW modules, channels_last activations)."""

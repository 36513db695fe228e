"""Image conversion and the training visualizer of the port."""

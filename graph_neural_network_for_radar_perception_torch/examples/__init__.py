"""The port's user entry points, each run as ``python -m
graph_neural_network_for_radar_perception_torch.examples.<name>``."""

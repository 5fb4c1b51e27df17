"""PyTorch/CUDA port of the radar GNN for NVIDIA Hopper.

The JAX package ``graph_neural_network_for_radar_perception_tpu`` is the
reference; this package imports none of it."""

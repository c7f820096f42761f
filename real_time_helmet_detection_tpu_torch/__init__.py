"""PyTorch + CUDA port of the helmet detector (eval/predict path).

The JAX package `real_time_helmet_detection_tpu` is the reference; this
package imports nothing of it, nor jax. See README.md "PyTorch / H100
port".
"""

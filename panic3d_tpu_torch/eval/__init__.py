"""Eval pipeline pieces of the port (panic3d_tpu/eval)."""

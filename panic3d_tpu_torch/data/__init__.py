"""Data backends of the port (panic3d_tpu/data)."""

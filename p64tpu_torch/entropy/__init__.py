"""p64tpu_torch subpackage."""

"""kernels subpackage."""

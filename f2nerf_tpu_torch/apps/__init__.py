"""apps subpackage."""

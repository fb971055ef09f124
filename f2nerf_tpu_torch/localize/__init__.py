"""localize subpackage."""

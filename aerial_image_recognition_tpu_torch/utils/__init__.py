"""Host helpers of the port (native libraries)."""

"""Host and geometry helpers of the port."""

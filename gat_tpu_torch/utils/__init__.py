"""Host-side helpers of the port."""

"""Host-side helpers of the port (its own copies of the reference's)."""

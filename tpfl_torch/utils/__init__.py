"""Framework helpers of the port."""

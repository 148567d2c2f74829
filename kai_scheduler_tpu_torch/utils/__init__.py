"""Numeric helpers of the port (the compensated prefix sum, kernel K5)."""

"""Framework-free helpers of the port: RNG streams and the weight bridge."""

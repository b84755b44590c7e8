"""JAX-free test data (synthetic world, BA problems) and ATE."""

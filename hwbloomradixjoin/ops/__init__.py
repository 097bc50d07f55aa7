"""Join, filter, hash, sort and aggregate operators as jnp/lax programs."""

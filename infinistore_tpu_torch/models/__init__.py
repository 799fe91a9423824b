"""Model families of the port."""

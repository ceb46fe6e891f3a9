"""Runtime pieces shared by the port's modules."""

"""The port's runnable examples (examples/ beside the package stays the JAX
package's)."""

"""Runtime core: scope, op registry, eager block runner."""

"""Weight bridge from the JAX package's variable trees and resizing."""

"""Padding rules shared by the graph builders.

The same multiples as the JAX package, so that a graph built by either
package from the same COO has the same padded shapes field for field.
"""

NODE_PAD_MULTIPLE = 8
EDGE_PAD_MULTIPLE = 1024

"""The port's apps: ``graphsage/node_classification.py`` and
``graphsage/node_classification_dist.py``, counterparts of the JAX
package's ``examples/graphsage``."""

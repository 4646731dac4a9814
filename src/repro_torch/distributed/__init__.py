from .hlo_analysis import collective_bytes, roofline_terms
from .sharding import Resolver, activate, distribute_model, replicated, shardings_for

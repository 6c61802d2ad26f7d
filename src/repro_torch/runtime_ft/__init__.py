"""repro.runtime_ft — fleet fault tolerance: heartbeats, PTT-based straggler
detection, elastic re-meshing on node loss."""
from .straggler import StragglerDetector
from .elastic import ElasticFleet, FleetEvent

__all__ = ["StragglerDetector", "ElasticFleet", "FleetEvent"]

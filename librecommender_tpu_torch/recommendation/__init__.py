from .cold_start import popular_recommendations
from .ranking import rank_recommendations

__all__ = ["popular_recommendations", "rank_recommendations"]

from .cold_start import cold_start_rec, popular_recommendations
from .ranking import rank_recommendations

__all__ = ["cold_start_rec", "popular_recommendations", "rank_recommendations"]

from .fid import (calculate_SIFID, calculate_SVFID,  # noqa: F401
                  calculate_frechet_distance)

from .fid import calculate_SIFID, calculate_frechet_distance  # noqa: F401

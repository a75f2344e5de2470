"""Small utilities: image grids written as PNG files."""

"""The reference's colours (port of the palette of
``gym_puzzles_tpu/render/raster.py``): black background, grey block with
white centre and vertex dots, white agents, blue goal disc (v0 / v3) or
white goal dot with a dark-grey margin ring (v2), dark-grey walls."""

GREY = (127, 127, 127)
WHITE = (255, 255, 255)
LT_GREY = (51, 51, 51)
BLUE = (58, 153, 255)

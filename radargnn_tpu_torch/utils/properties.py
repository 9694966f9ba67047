"""RadarScenes class properties: labels, colors, class-frequency weights.

Port of `radargnn_tpu/utils/properties.py`.
"""


class Labels:
    """Label-ID ↔ class-name mapping (RadarScenes reduced 5-class + background)."""

    @staticmethod
    def get_label_dict():
        return {
            0: "car",
            1: "pedestrian",
            2: "pedestrian group",
            3: "two wheeler",
            4: "large vehicle",
            5: "background",
        }


class Colors:
    """Color palette for plots; sensor-id and label-id mappings."""

    red = "#f02b2b"
    blue = "#4763ff"
    green = "#47ff69"
    light_green = "#73ff98"
    orange = "#ff962e"
    violet = "#c561d4"
    indigo = "#8695e3"
    grey = "#7f8c8d"
    yellow = "#ffff33"
    lime = "#c6ff00"
    amber = "#ffd54f"
    teal = "#19ffd2"
    pink = "#ff6eba"
    brown = "#c97240"
    black = "#1e272e"
    midnight_blue = "#34495e"
    deep_orange = "#e64a19"
    light_blue = "#91cded"
    light_gray = "#dedede"
    gray = "#888888"

    sensor_id_to_color = {1: red, 2: blue, 3: green, 4: pink}

    label_id_to_color = {
        0: violet, 1: orange, 2: green, 3: pink, 4: light_blue, 5: gray,
        6: brown, 7: yellow, 8: light_green, 9: blue, 10: indigo, 11: teal,
    }

    object_colors = [red, blue, green, light_green, orange, violet, yellow,
                     teal, pink, brown, light_blue, lime, deep_orange, amber,
                     indigo]


class ClassDistribution:
    """Class-frequency based loss weights (weight ∝ 1/count, normalized to two-wheeler)."""

    @staticmethod
    def get_radar_point_dict():
        return {
            "car": 2.1e6,
            "pedestrian": 5.1e5,
            "pedestrian group": 1.1e6,
            "two wheeler": 2.7e5,
            "large vehicle": 9e5,
            "background": 1.3e8,
        }

    @staticmethod
    def get_class_weights():
        counts = ClassDistribution.get_radar_point_dict()
        ref = counts["two wheeler"]
        return {name: ref / count for name, count in (
            ("car", counts["car"]),
            ("pedestrian", counts["pedestrian"]),
            ("pedestrian group", counts["pedestrian group"]),
            ("two wheeler", counts["two wheeler"]),
            ("large vehicle", counts["large vehicle"]),
            ("background", counts["background"]),
        )}

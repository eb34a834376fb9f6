"""The annotation prompt as the reference's runner lays it out
(run_opus_ddp.py:102-107, the curious-student template), rebuilt here so
that the check tokenizes what the program should have fed the model."""

SYSTEM = ("A chat between a curious student and a biological professor who "
          "is familiar with protein properties. The biological professor "
          "gives helpful, detailed, and professional answers to student's "
          "questions.")
LOCALIZATION_SUFFIX = "Kindly reply with only one word."


def annotation_prompt(instruction: str, task: str) -> str:
    """`<seq>` + newline + the instruction (localization adds its one-word
    suffix) inside the Student / Professor turns."""
    if "<seq>" not in instruction:
        suffix = LOCALIZATION_SUFFIX if task == "localization" else ""
        instruction = "<seq>\n" + instruction + suffix
    return (f"{SYSTEM}\n\n### Student: {instruction}\n### Professor:")

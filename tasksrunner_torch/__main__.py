from tasksrunner_torch.cli import main

main()
